"""The flash kernels' roofline share, read from the traced window."""

from portbench.counts.flash import kernel_bounds


def roofline(run, kernels):
    """Sum over ``kernels`` of bound x launches, over their device time, %.
    None where the window ran none of them."""
    if run.trace is None:
        return None
    spec = run.cell.job["inputs"]
    cfg = run.cell.config
    H = int(cfg["num_attention_heads"])
    bounds = kernel_bounds(int(spec["batch"]), int(spec["seq_len"]), H,
                           int(cfg["hidden_size"]) // H)
    least = spent = 0.0
    for k in kernels:
        seconds, launches = run.trace.kernel_s(f"{k}_kernel")
        least += bounds[k] * launches
        spent += seconds
    return 100.0 * least / spent if spent > 0 else None
