"""bound_share.solve (%, the csrc kernels; moves mlups): per card, the
least time the card could take for the lattice updates it made in the
traced sub-window, over the time it was busy; the mean over the cards.

The least time is the larger of the updates' fp32 operations over the
peak rate and the bytes over the peak bandwidth. The work is counted from
the cell's shapes and steps, whatever implements it: each update is
``OPS_PER_UPDATE`` operations (the plain step's count of the reference's
arithmetic); each runner call reads its input state and mask once and
writes its output state once. The updates are shared out evenly over the
cell's cards. Peaks: NVIDIA's H100 SXM data sheet at 700 W (fp32 outside
the tensor cores; HBM3)."""

OPS_PER_UPDATE = 94
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BYTES_PER_CELL = 9 * 4 + 1 + 9 * 4     # state in, mask, state out


def read(run):
    s = run.session
    if not s.device or not s.steps:
        return None
    cells = run.cells / len(run.cards)
    bound = max(cells * s.steps * OPS_PER_UPDATE / PEAK_FLOPS,
                cells * s.units * BYTES_PER_CELL / PEAK_BYTES)
    shares = [bound / s.busy[c] for c in run.cards if s.busy[c] > 0]
    if not shares:
        return None
    return 100.0 * sum(shares) / len(shares)
