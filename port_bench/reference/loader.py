"""The batches a seeded, shuffled, host-augmented loader gives, worked out
again in NumPy: a frozen copy of the arithmetic of the native batcher that
the program's training loader uses (``native/batcher.cpp``).

- An epoch's order: indices 0..n-1 shuffled by ``std::shuffle`` (as
  libstdc++ 11 and later implement it, taking two swap positions from one
  draw where the generator's range allows) under a ``std::mt19937_64``
  seeded with ``mix(seed, epoch)``.
- A sample's key: ``mix(mix(seed, epoch), position in the epoch)``; its
  low bit flips the image left-right (with flipping on), the rest picks
  the crop's offsets in [-pad, pad] (row, then column) on an
  edge-replicated canvas.
- Pixels: a uint8 image times float32(1/255).
"""

from typing import Tuple

import numpy as np

M64 = (1 << 64) - 1


def mix(a: int, b: int) -> int:
    """splitmix64-style combine of two 64-bit values."""
    z = (a + 0x9E3779B97F4A7C15 * (b + 1)) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


class MT19937_64:
    """The 64-bit Mersenne Twister of the C++ standard library."""

    N, M = 312, 156

    def __init__(self, seed: int):
        mt = [seed & M64]
        for i in range(1, self.N):
            prev = mt[-1]
            mt.append((6364136223846793005 * (prev ^ (prev >> 62)) + i) & M64)
        self.mt, self.i = mt, self.N

    def _twist(self):
        mt, N, M = self.mt, self.N, self.M
        upper, lower = 0xFFFFFFFF80000000, 0x7FFFFFFF
        for k in range(N):
            x = (mt[k] & upper) | (mt[(k + 1) % N] & lower)
            xa = x >> 1
            if x & 1:
                xa ^= 0xB5026F5AA96619E9
            mt[k] = mt[(k + M) % N] ^ xa
        self.i = 0

    def __call__(self) -> int:
        if self.i >= self.N:
            self._twist()
        y = self.mt[self.i]
        self.i += 1
        y ^= (y >> 29) & 0x5555555555555555
        y ^= (y << 17) & 0x71D67FFFEDA60000
        y ^= (y << 37) & 0xFFF7EEE000000000
        y ^= y >> 43
        return y & M64


def uniform_below(g: MT19937_64, n: int) -> int:
    """libstdc++'s ``uniform_int_distribution{0, n - 1}`` over a 64-bit
    generator: Lemire's multiply-and-reject."""
    product = g() * n
    low = product & M64
    if low < n:
        threshold = ((1 << 64) - n) % n
        while low < threshold:
            product = g() * n
            low = product & M64
    return product >> 64


def shuffled(n: int, seed: int) -> np.ndarray:
    """``std::shuffle`` of 0..n-1 under ``std::mt19937_64(seed)``."""
    order = list(range(n))
    if n == 0:
        return np.array(order, np.int64)
    g = MT19937_64(seed)
    i = 1
    if M64 // n >= n:
        if n % 2 == 0:
            j = uniform_below(g, 2)
            order[i], order[j] = order[j], order[i]
            i += 1
        while i != n:
            r = i + 1
            x = uniform_below(g, r * (r + 1))
            a, b = x // (r + 1), x % (r + 1)
            order[i], order[a] = order[a], order[i]
            order[i + 1], order[b] = order[b], order[i + 1]
            i += 2
    else:
        for i in range(1, n):
            j = uniform_below(g, i + 1)
            order[i], order[j] = order[j], order[i]
    return np.array(order, np.int64)


def epoch_batches(data: np.ndarray, labels: np.ndarray, batch_size: int,
                  seed: int, epoch: int, count: int, flip: bool,
                  crop_pad: int) -> list:
    """The first ``count`` batches ``(x float32 (B, C, H, W), y int64)`` of
    the epoch, shuffled and augmented as the native batcher does."""
    n, _, h, w = data.shape
    seed &= M64
    order = shuffled(n, mix(seed, epoch))
    base = mix(seed, epoch)
    out = []
    for b in range(count):
        pos = np.arange(b * batch_size, (b + 1) * batch_size)
        idx = order[pos]
        keys = [mix(base, int(p)) for p in pos]
        xs = []
        for src, key in zip(idx, keys):
            img = data[src]
            r, fl, dy, dx = key, False, 0, 0
            if flip:
                fl, r = bool(r & 1), r >> 1
            if crop_pad:
                span = 2 * crop_pad + 1
                dy, r = r % span - crop_pad, r // span
                dx = r % span - crop_pad
            gy = np.clip(np.arange(h) + dy, 0, h - 1)
            gx0 = np.arange(w) + dx
            gx = np.clip((w - 1 - gx0) if fl else gx0, 0, w - 1)
            xs.append(img[:, gy][:, :, gx])
        x = np.stack(xs).astype(np.float32) * np.float32(1.0 / 255.0)
        out.append((x, labels[idx].astype(np.int64)))
    return out


def augmentation(names, height: int) -> Tuple[bool, int]:
    """(flip, crop pad) of a list of augmentations ('flip', 'crop'): the
    crop pads by an eighth of the image's height."""
    flip = any(a.startswith(('flip', 'hflip')) for a in names)
    crop = max(height // 8, 1) if any(a.startswith('crop')
                                      for a in names) else 0
    return flip, crop
