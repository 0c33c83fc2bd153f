"""JAX's persistent compilation cache for one test module of the port.

The JAX package runs its layer loops as ``lax.scan`` over a closure made
anew at every call, so each call of a reference entry point (a decode
step, a prefill, an engine step) traces its body again and hands XLA a
new computation to compile, though its HLO is the one compiled at the
previous call. A parity test that steps the reference dozens of times
spends most of its time in XLA's compiler.

``jax_compile_cache`` (autouse, module scope) turns JAX's persistent
compilation cache on for the module, in a directory of its own under
pytest's temporary directory, for every computation whatever its
compile time or size: a computation whose HLO was compiled before in
the module loads that executable instead of compiling it again. The
executable is the one XLA built, so every number a test compares is the
same as without the cache; only compile time is saved. The previous
settings are restored after the module.

A test module takes it with ``from jax_compile_cache import
jax_compile_cache  # noqa: F401``.
"""
import jax
import pytest
from jax._src import compilation_cache

_SETTINGS = {"jax_compilation_cache_dir": None,
             "jax_persistent_cache_min_compile_time_secs": 0.0,
             "jax_persistent_cache_min_entry_size_bytes": -1}


@pytest.fixture(autouse=True, scope="module")
def jax_compile_cache(tmp_path_factory):
    old = {k: getattr(jax.config, k) for k in _SETTINGS}
    new = dict(_SETTINGS, jax_compilation_cache_dir=str(
        tmp_path_factory.mktemp("jax_compile_cache")))
    for k, v in new.items():
        jax.config.update(k, v)
    compilation_cache.reset_cache()
    yield
    for k, v in old.items():
        jax.config.update(k, v)
    compilation_cache.reset_cache()
