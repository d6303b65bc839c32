"""The flash kernel's share of its roofline over the traced stretch, in
percent: the least time its calls need (each layer's call of each
admission dispatched in the stretch, bytes and FLOPs from its shape) over
the kernel's device time in the trace. Flash time in the stretch with no
admission noted there means the harness no longer sees the program's
admissions (``client.Clients``): that is an error, not a missing reading."""

from portbench.harness import is_flash
from portbench.yardstick import bound_s, flash_call


def read(run):
    if run.ops is None:
        return None
    a, b = run.host_trace
    h, dh, layers = (run.cfg["num_attention_heads"], run.cfg["head_dim"],
                     run.cfg["num_hidden_layers"])
    need = sum(layers * bound_s(*flash_call(len(lens), bucket, h, dh))
               for t, bucket, _, lens in run.admissions if a <= t < b)
    took = run.kernel_s(is_flash)
    if took > 0 and need == 0:
        raise RuntimeError("flash kernels ran in the traced stretch but no admission was noted "
                           "there: the harness's hook on the engine's admission is gone")
    return 100.0 * need / took if need > 0 and took > 0 else None
