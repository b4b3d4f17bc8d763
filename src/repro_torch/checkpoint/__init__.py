"""Named-array ``.npz`` files in the reference's manifest format."""

from repro_torch.checkpoint.ckpt import load_arrays, save_arrays

__all__ = ["load_arrays", "save_arrays"]
