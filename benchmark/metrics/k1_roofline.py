"""``k1_roofline``: K1 (``dupl::exp_attention``) at its share of its
roofline, in %: the least times of its launches, each from its recorded
(B, N, H, D) shapes (``counts.k1_bound``), summed, over the device time of
the kernels those launches ran, in the profiler's pass."""

from benchmark import counts, trace


def read(ctx):
    got = ctx.op_kernels("dupl::exp_attention")
    if not got:
        return None
    ops, kerns = got
    bound = sum(counts.k1_bound(*trace.input_dims(o)[0]) for o in ops)
    busy = sum(float(k["dur"]) for k in kerns) * 1e-6
    return 100.0 * bound / busy if busy and bound else None
