"""scan.idle_in_frame_loop_share: the share of the first card's idle time in
the traced window (no kernel, copy or fill running) that falls inside one
of the program's `scan.frame_loop` spans, in %: how much of the card's
waiting the host spends enqueueing the frame loops."""

from portbench.metrics._program import idle_intervals, overlap_ns, union, window_spans


def read(run):
    tl = run.counters["timeline"]
    loops = union((s.start_ns, s.end_ns) for s in window_spans(run, "scan.frame_loop"))
    cards = tl.cards()
    if not loops or not cards:
        return None
    idle = idle_intervals(tl, cards[0])
    total = sum(e - s for s, e in idle)
    return 100.0 * overlap_ns(idle, loops) / total if total else None
