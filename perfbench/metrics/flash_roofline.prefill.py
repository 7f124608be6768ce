"""``flash_attention_tc``'s share of its roofline in the prefill: the
causal operations of a (B, S, H, hd) launch at the bf16 peak over its
device time, averaged over the window's launches (one a layer a batch)."""
from perfbench import counts, readers


def read(run):
    times = readers.kernel_times(run, "flash_fwd_kernel_tc")
    m = run.m
    if not times or len(times) != m.layers * len(run.batches):
        return None
    S = run.traffic["prompt_len"]
    bound = sum(counts.flash_causal_flops(len(b["ids"]), S, m.heads,
                                          m.head_dim) / counts.BF16_FLOPS
                for b in run.batches for _ in range(m.layers))
    return readers.share_pct(bound, sum(times))
