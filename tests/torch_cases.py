"""Seeded kernel inputs and comparisons shared by the port's kernel tests
(``test_torch_kernels.py`` against the reference on the CPU,
``test_torch_cuda.py`` against the plain versions on the card).  Imports
torch and numpy only."""

import numpy as np
import torch


def tt(a: np.ndarray, device="cpu") -> "torch.Tensor":
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def same(got, want) -> None:
    """Bit-equality; torch int32 bitmaps compare as uint32 words."""
    got, want = (x.cpu().numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x) for x in (got, want))
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    np.testing.assert_array_equal(got, want)
    assert got.shape == want.shape


def edge_inputs(m, b, seed):
    rng = np.random.default_rng(seed)
    nbr = np.sort(rng.integers(0, 500, size=m)).astype(np.int32)
    lo = rng.integers(0, m, size=b).astype(np.int32)
    hi = np.minimum(m, lo + rng.integers(0, 50, size=b)).astype(np.int32)
    hi[::7] = lo[::7]  # empty slices
    hit = rng.random(b) < 0.5
    tgt = np.where(hit & (hi > lo), nbr[np.minimum(lo, m - 1)],
                   rng.integers(-1, 520, size=b)).astype(np.int32)
    n_iters = max(2, int(np.ceil(np.log2(max(2, int((hi - lo).max()))))) + 1)
    return (nbr, lo, hi, tgt), n_iters


def tile_inputs(r, ta, tb, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-1, 40, size=(r, ta)).astype(np.int32)
    b = rng.integers(-1, 40, size=(r, tb)).astype(np.int32)
    b = np.where(b < 0, -2, b).astype(np.int32)  # adjacency tile padding
    return a, b


def bitmap_inputs(b, w, seed):
    rng = np.random.default_rng(seed)
    bm = rng.integers(0, 2**32, size=(b, w), dtype=np.uint64).astype(np.uint32)
    req = np.zeros(w, np.uint32)
    req[0] = np.uint32(0x80000001)  # high bit: the int32 pattern is negative
    if w > 1:
        req[-1] = np.uint32(0x00F0F000)
    bm[::3] |= req  # a third certainly pass
    return bm, req


def sig_inputs(v, w2, b, seed):
    rng = np.random.default_rng(seed)
    sig = rng.integers(0, 2**32, size=(v, w2), dtype=np.uint64).astype(np.uint32)
    req = (sig[0] & np.uint32(0x90010003)).astype(np.uint32)
    ids = rng.integers(-3, v + 3, size=b).astype(np.int32)  # out of range clamps
    return sig, ids, req


def efc_inputs(r, v, w, seed, with_mask=True, bound=None, empty_every=3):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, size=r).astype(np.int32)
    deg[::empty_every] = 0  # empty rows
    m = max(1, int(deg.sum()) + 5)
    nbr = rng.integers(0, v, size=m).astype(np.int32)
    start = np.zeros(r, np.int32)
    pos = 0
    for i in range(r):
        start[i] = pos
        pos += int(deg[i])
    offs = (np.cumsum(deg) - deg).astype(np.int32)
    bitmap = rng.integers(0, 2**32, size=(v, w), dtype=np.uint64).astype(np.uint32)
    mask = np.zeros(w, np.uint32)
    if with_mask:
        mask[0] = np.uint32(0x5)
        mask[-1] |= np.uint32(0x80000000)
    bid = int(nbr[rng.integers(m)]) if bound is None else bound
    return (nbr, bitmap, start, deg, offs, mask), bid, int(deg.sum())


EFC_CASES = [
    # r, v, w, capacity, with_mask, bound: None = a present id, -1 = none
    (1, 4, 1, 8, True, -1),
    (10, 16, 1, 64, True, -1),
    (10, 16, 2, 64, False, None),
    (40, 64, 5, 256, True, -1),
    (40, 64, 2, 16, True, -1),  # total > capacity
    (64, 32, 1, 512, True, None),
    (33, 20, 5, 128, False, -1),
]
