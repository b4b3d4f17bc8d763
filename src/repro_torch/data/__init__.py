"""Synthetic data of the port (numpy only, bit-identical to the reference's)."""

from repro_torch.data.pipeline import (TokenStream, jet_substructure_data,
                                       mnist_like_data)

__all__ = ["TokenStream", "jet_substructure_data", "mnist_like_data"]
