"""Synthetic data of the port (numpy only, bit-identical to the reference's)."""

from repro_torch.data.pipeline import jet_substructure_data

__all__ = ["jet_substructure_data"]
