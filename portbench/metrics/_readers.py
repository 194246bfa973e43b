"""What the per-layer readers of the service's cells (`*.serve`) and the
sweep's cells (`*.sweep`) share: each quantity is one metric a kind of
cell, since each moves its own kind's end-to-end metric (the service's
`request_p95_ms`, the sweep's `members_per_s.sweep`)."""
from portbench import counts, loadgen


def launches_per_call(view, log):
    """Fused-core stack launches a call, from the port's own counter
    (`ertdx_torch.ops.core_block.launches["fused_core_stack"]`), read
    before the window and after its last call returned, over the calls
    sent in it: an exact count (DDIM's steps where the fused core serves
    every step)."""
    calls = sum(r.error is None for r in view.records)
    return view.launches / calls if calls else None


def stack_roofline(view, log):
    """The fused core stack kernel's share of its roofline: the bound of
    one launch (`counts.core_stack_bound_s`: its operations at the bf16
    peak or its bytes at the memory's rate, the larger) over its mean
    device time in the traced stretch (torch.profiler's kernel
    records)."""
    if view.trace is None:
        return None
    times = view.trace.kernel_times(counts.STACK_KERNEL)
    if not times:
        return None
    mean = sum(times) / len(times)
    bound = counts.core_stack_bound_s(**view.stack_shape)
    log(f"{counts.STACK_KERNEL}: {len(times)} records, mean "
        f"{mean * 1e3:.4f} ms, bound {bound * 1e3:.4f} ms")
    return 100.0 * bound / mean


def call_mfu(view, log):
    """The whole call's share of the card's bf16 peak while calls run:
    the operations of the calls done in the window (`counts.call_flops`
    a call: the encoder a survey, the cross K/V, every denoiser step on
    the fused core; calls counted as `loadgen.window_share` counts them)
    over the time in the window in which at least one call was in the
    program, times 989 TFLOP/s. A closed loop keeps a call in the program
    all through the window; an open loop's idle time between requests is
    left out, so the number reads the calls' speed and not the offered
    rate."""
    end = view.window_start + view.window_s
    done = sum(loadgen.window_share(r, end) for r in view.records)
    spans = sorted((r.start, min(r.end, end)) for r in view.records
                   if r.error is None and r.start < end)
    busy, reach = 0.0, view.window_start
    for s, e in spans:
        busy += max(0.0, e - max(s, reach))
        reach = max(reach, e)
    if not done or busy <= 0:
        return None
    return 100.0 * done * view.call_flops / (busy * counts.PEAK_BF16_FLOPS)


def idle_pct(view, log):
    """The share of the traced stretch with no kernel running on the
    card, from torch.profiler's kernel intervals. The profiler has
    dropped kernel records before, so the count of stack-kernel records
    is compared with the port's launch counter over the stretch and a
    mismatch logged."""
    tr = view.trace
    if tr is None or not tr.kernels:
        return None
    seen = len(tr.kernel_times(counts.STACK_KERNEL))
    if seen != tr.launches:
        log(f"device_idle_pct: the trace holds {seen} stack-kernel records "
            f"of {tr.launches} launches; records were dropped")
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
