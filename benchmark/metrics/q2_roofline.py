"""``q2_roofline``: Q2 (``dupl::int8_linear``, the w8a8 product) at its
share of its roofline, in %: the least times of its launches, each from
its recorded (M, K) and (N, K) operands (``counts.q2_bound``), summed, over
the device time of the kernels those launches ran, in the profiler's
pass."""

from benchmark import counts, trace


def read(ctx):
    got = ctx.op_kernels("dupl::int8_linear")
    if not got:
        return None
    ops, kerns = got
    bound = 0.0
    for o in ops:
        (m, k), _, (n, _k) = trace.input_dims(o)[:3]
        bound += counts.q2_bound(m, n, k)
    busy = sum(float(k["dur"]) for k in kerns) * 1e-6
    return 100.0 * bound / busy if busy and bound else None
