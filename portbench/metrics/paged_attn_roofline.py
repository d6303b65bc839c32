"""The paged decode kernel's share of its roofline over the traced
stretch, in percent: the least time the decode ticks behind the tokens
delivered in the stretch need (each token's row in each layer: its keys
and values read once, its query and output, its page-table entries) over
the kernel's device time in the trace (split walk and combine)."""

from portbench.harness import PAGED_MARGIN_NS, is_paged
from portbench.yardstick import bound_s, paged_row


def read(run):
    if run.ops is None:
        return None
    a, b = run.host_trace
    h, dh, layers = (run.cfg["num_attention_heads"], run.cfg["head_dim"],
                     run.cfg["num_hidden_layers"])
    page = run.cfg["serving"]["kv_page"]
    nbytes = flops = 0
    for r, i in run.tokens_between(a + PAGED_MARGIN_NS, b):
        if i > 0:
            nb, fl = paged_row(len(r.prompt) + i, h, dh, page)
            nbytes += layers * nb
            flops += layers * fl
    took = run.kernel_s(is_paged)
    return 100.0 * bound_s(nbytes, flops) / took if nbytes > 0 and took > 0 else None
