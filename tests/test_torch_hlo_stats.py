"""The port's collective accounting against the reference's HLO parser.

The reference reads each collective's result buffer out of compiled HLO
text; the port records ``(kind, result bytes)`` of the functional
collectives a step issues (``launch.hlo_stats.CollectiveRecorder``).  A
record holding the same ops and buffers as ``tests/test_hlo_stats.py``'s
HLO must give the same dict, key for key: the wire factors (all-reduce
2.0, the rest 1.0), the totals and the ``n_*`` counts.
"""

import pytest

from repro.launch import hlo_stats as R

from repro_torch.launch import hlo_stats as H

HLO = """
  %all-reduce.5 = f32[1024,128]{1,0} all-reduce(f32[1024,128]{1,0} %add.3)
  %ag = bf16[256,512]{1,0} all-gather(bf16[128,512]{1,0} %p0)
  %rs.1 = f32[64]{0} reduce-scatter(f32[512]{0} %x)
  %a2a = (f32[8,16]{1,0}, f32[8,16]{1,0}) all-to-all(f32[8,16] %a, f32[8,16] %b)
  %cp = u32[4]{0} collective-permute(u32[4]{0} %c)
  %dot.1 = f32[10,10]{1,0} dot(f32[10,10] %l, f32[10,10] %r)
  %ar-start = f32[32]{0} all-reduce-start(f32[32]{0} %y)
  %ar-done = f32[32]{0} all-reduce-done(f32[32]{0} %ar-start)
"""

# the same collectives as issued: (kind, per-device result bytes)
RECORD = [("all-reduce", 1024 * 128 * 4), ("all-gather", 256 * 512 * 2),
          ("reduce-scatter", 64 * 4), ("all-to-all", 2 * 8 * 16 * 4),
          ("collective-permute", 4 * 4), ("all-reduce", 32 * 4)]


@pytest.mark.parametrize("record,hlo", [
    (RECORD, HLO),
    ([], "%add = f32[2] add(f32[2] %a, f32[2] %b)"),
    (RECORD[1:2] * 3, "\n".join([HLO.splitlines()[2]] * 3)),
])
def test_collective_bytes_equal_reference(record, hlo):
    assert H.collective_bytes(record) == R.collective_bytes(hlo)


def test_kinds_and_wire_factors_equal_reference():
    assert H.COLLECTIVES == R.COLLECTIVES
    assert H._WIRE_FACTOR == R._WIRE_FACTOR
    assert set(H._KIND_OF_OP.values()) <= set(H.COLLECTIVES)

