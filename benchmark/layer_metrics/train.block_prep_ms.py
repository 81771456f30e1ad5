"""Host time a training step spends preparing the fused blocks' launches:
the port's ``fused_block.prep`` and ``fused_block_bwd.prep`` spans (f32
copies, weight tiles and buffers before each K1 save and K2 call), on any
thread (the backward's run on autograd's), per ``train.step`` span of the
traced part."""

from benchmark import program_spans as ps

SPANS = ["fused_block.prep", "fused_block_bwd.prep"]


def read(run):
    tr = run.trace
    if tr is None:
        return None
    return ps.per_root(tr, ps.span_host_s(tr, SPANS), "train.step")
