from repro_torch.sim.des import (FleetDES, PoolStats, simulate_pool,  # noqa: F401
                           validation_table)
