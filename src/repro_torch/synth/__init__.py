"""Two-level logic synthesis: SOP covers over reachable on-sets (the port's
copy of ``repro.synth``).

The in-repo replacement for the synthesis step the paper delegates to
Vivado — see :mod:`repro_torch.synth.sop` for the cover IR and
:mod:`repro_torch.synth.minimize` for the Quine–McCluskey minimizer.
"""

from repro_torch.synth.minimize import (
    DEFAULT_MAX_BITS,
    DEFAULT_MAX_CUBES,
    minimize_bit,
    minimize_table,
    synthesize_netlist,
)
from repro_torch.synth.sop import Cube, SopCover

__all__ = [
    "Cube",
    "SopCover",
    "DEFAULT_MAX_BITS",
    "DEFAULT_MAX_CUBES",
    "minimize_bit",
    "minimize_table",
    "synthesize_netlist",
]
