"""Device ms a training step under the program's ``ssm`` spans (each
Mamba2 layer's norm and mixer: forward, recompute and the backward linked
to them), from the span segment of a traced run (``harness/spans.py``);
None where the segment did not stand or the program opens no such
span."""


def read(run):
    s = run.spans
    if s is None or not any("ssm" in p.split("/") for p in s.by_path()):
        return None
    return 1e3 * s.span_s("ssm")
