"""The device an entry point runs on."""
import torch


def resolve_device(name: str) -> torch.device:
    """The device named ``name``; a CUDA device must exist (no silent CPU
    fallback). f32 products stay full f32 on the card: TF32 off."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device is "
                               "available (pass --device cpu to run the "
                               "plain PyTorch path on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
