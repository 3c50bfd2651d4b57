"""B2's share of its roofline over the traced steps: the least time for
each step's forward, input gradient and weight gradient
(portbench/counts.b2_counts; compute bounds it) over the summed time of
B2's projection, forward, backward and reduction kernels."""

from portbench import counts

B2_KERNELS = ("ntm_token_proj_kernel", "ntm_bptt_fwd_kernel", "ntm_bptt_bwd_kernel",
              "ntm_grad_partial_kernel", "ntm_grad_sum_kernel")


def read(m):
    t = m.trace
    if t is None or m.card is None:
        return None
    busy = t.kernel_seconds(*B2_KERNELS)
    if busy <= 0:
        return None
    tr = m.run.traffic
    flops, nbytes = counts.b2_counts(m.run.conf, tr["batch"], tr["sequence_length"])
    least, _ = counts.least_seconds(flops * t.steps, nbytes * t.steps, m.card)
    return 100.0 * least / busy
