"""A plain model of K1's ``scalar_runs`` (1 x 1 x 1 blocks): how the kernel
splits the pairs among warps and in what order it sums each run, and the
pair lists its tests run on.  Imports neither JAX nor the card: the CPU
tests (``test_torch_k1_scalar.py``) hold it against the JAX package, the
card's (``test_torch_gpu.py``) hold the kernel's bits against it."""
import numpy as np

from repro_torch.core.matrices import mcl_instance
from repro_torch.kernels.bsr_spgemm import build_pair_lists, pair_runs

GROUP = 4  # pairs a lane adds in order, from its run's start (csrc: kGroup)
PIECE = 32 * GROUP  # pairs of a run summed as one piece, a group a lane (csrc: kPiece)
MIN_SPAN = 64  # fewest pairs a warp's span holds (csrc: kMinSpan)


def products(x, y) -> np.ndarray:
    return (np.asarray(x, np.float32) * np.asarray(y, np.float32)).astype(np.float32)


def group_sum(p: np.ndarray) -> np.float32:
    """A lane's group: its fp32 products added in order."""
    total = p[0]
    for v in p[1:]:
        total = np.float32(total + v)
    return total


def piece_sum(p: np.ndarray) -> np.float32:
    """A piece's products (up to PIECE) summed as the warp sums them: each
    GROUP from the piece's start by ``group_sum`` on a lane of its own,
    then, at each step off = 1, 2, 4, ..., lane j adds lane j + off where
    that lies in the piece (all lanes at once); the sum ends on lane 0."""
    v = np.array([group_sum(p[g:g + GROUP]) for g in range(0, len(p), GROUP)], np.float32)
    off = 1
    while off < len(v):
        v[:len(v) - off] = v[:len(v) - off] + v[off:]
        off *= 2
    return v[0]


def run_sum(p: np.ndarray, s: int, e: int) -> np.float32:
    """Run [s, e): its pieces of PIECE pairs from s, each ``piece_sum``,
    added in order."""
    total = None
    for f in range(s, e, PIECE):
        piece = piece_sum(p[f:min(f + PIECE, e)])
        total = piece if total is None else np.float32(total + piece)
    return total


def runs_own_order(x, y, run_start, run_c, n_c) -> np.ndarray:
    """The sum each run gets, by its pairs alone (``run_sum`` of the fp32
    products ``x[i] * y[i]``); zero where no run lands."""
    p = products(x, y)
    out = np.zeros(n_c, np.float32)
    for s, e, c in zip(run_start[:-1].tolist(), run_start[1:].tolist(), run_c.tolist()):
        out[c] = run_sum(p, s, e)
    return out


def scalar_walk(x, y, pair_c, n_c, span):
    """scalar_runs in plain Python: ``x[i] * y[i]`` summed into C slot
    ``pair_c[i]``.  Warp w owns the runs that start in [w span, (w + 1)
    span) and walks their pieces in windows of 32 lanes, a group of GROUP
    pairs a lane: a window takes its first run's next piece, then the whole
    runs after it while their groups fit; a run's pieces are added in
    order, its sum so far carried from window to window.  The warp writes
    the zeros before each run it owns and, owning the last run, after it.
    C slots start as NaN, as an unfilled allocation may.  Returns (C, how
    many times each pair was summed, every window's lanes used)."""
    run_start, run_c = (v.astype(np.int64) for v in pair_runs(pair_c))
    p = products(x, y)
    n, n_runs = len(pair_c), len(run_c)
    out = np.full(n_c, np.nan, np.float32)
    summed = np.zeros(n, np.int64)
    windows = []
    for w in range(-(-n // span)):
        s0, s1 = w * span, min((w + 1) * span, n)
        owned = [r for r in range(int(np.searchsorted(run_start[:-1], s0)), n_runs)
                 if run_start[r] < s1]
        pieces = [(r, f, min(f + PIECE, int(run_start[r + 1])))
                  for r in owned for f in range(int(run_start[r]), int(run_start[r + 1]), PIECE)]
        sums = {}
        k = 0
        while k < len(pieces):
            lanes = 0
            while k < len(pieces):
                r, f, g = pieces[k]
                groups = -(-(g - f) // GROUP)
                whole = f == run_start[r] and g == run_start[r + 1]
                if lanes and (not whole or lanes + groups > 32):
                    break
                lanes += groups
                summed[f:g] += 1
                piece = piece_sum(p[f:g])
                sums[r] = piece if f == run_start[r] else np.float32(sums[r] + piece)
                if f == run_start[r]:
                    out[(run_c[r - 1] if r else -1) + 1:run_c[r]] = 0.0
                if g == run_start[r + 1]:
                    out[run_c[r]] = sums[r]
                    if r == n_runs - 1:
                        out[run_c[r] + 1:] = 0.0
                k += 1
            windows.append(lanes)
    return out, summed, windows


def runs_case(lengths, slots, n_c, seed, garbage=0):
    """Tables of 64 full-mantissa N(0, 1) values each (the last 0.0), and
    pair lists with runs of ``lengths`` into C ``slots`` (ascending, gaps
    allowed), then ``garbage`` padding pairs reading the zeros into slot
    n_c - 1."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    a[-1] = b[-1] = 0.0
    n = int(np.sum(lengths))
    pa = np.r_[rng.integers(0, 63, n), np.full(garbage, 63)]
    pb = np.r_[rng.integers(0, 63, n), np.full(garbage, 63)]
    pc = np.r_[np.repeat(slots, lengths), np.full(garbage, n_c - 1)]
    return a, b, pa, pb, pc, n_c


def hub():  # runs of 1,000 and 300 pairs among short ones: many pieces, many spans
    lengths = [1, 2, 3, 1000, 2, 1, 5, 300, 1, 1]
    return runs_case(lengths, np.arange(len(lengths)), len(lengths), 0)


def _span_edges():  # runs ending exactly at span and window edges, and one pair off them
    lengths = [64, 64, 128, 63, 1, 65, 127, 1, 192, 66, 62, 32, 32, 31, 33]
    return runs_case(lengths, np.arange(len(lengths)), len(lengths), 1)


def _one_pair_runs():  # one-pair runs on both sides of each span edge
    lengths = [62, 1, 1, 1, 1, 61, 1, 1, 1, 1, 125, 1, 1, 32, 1, 30, 1, 1]
    return runs_case(lengths, np.arange(len(lengths)), len(lengths), 2)


def _uncovered():  # C slots before, between and after the runs that no run covers
    lengths = [3, 200, 1, 1, 140, 9]  # a gap of 91 slots and 98 after: the warp's
    return runs_case(lengths, np.array([2, 3, 7, 8, 100, 101]), 200, 3)


def _garbage():  # a monoC plan's trailing padding run into a last slot
    lengths = [7, 130, 1, 2, 60]
    return runs_case(lengths, np.arange(5), 6, 4, garbage=133)


def mcl_facebook():  # MCL-facebook at scale 0.05, squared: 389,174 pairs in 39,890 runs
    inst = mcl_instance("facebook", 0.05)
    (ar, ac), (br, bc) = inst.a.coo(), inst.b.coo()
    pa, pb, pc, crows, _ = build_pair_lists(ar, ac, br, bc)
    rng = np.random.default_rng(5)
    a = rng.standard_normal(len(ar)).astype(np.float32)
    b = rng.standard_normal(len(br)).astype(np.float32)
    return a, b, pa, pb, pc, len(crows)


CASES = {"hub": hub, "span_edges": _span_edges, "one_pair_runs": _one_pair_runs,
         "uncovered": _uncovered, "garbage": _garbage}
