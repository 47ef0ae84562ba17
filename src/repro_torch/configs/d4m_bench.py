"""The paper's workloads, regenerated with numpy from a seed.

* :func:`make_dataset` — the paper's own uniform workload (§III.A, Figs
  3–7): for size n, 8·2^n uniformly random integer keys in [0, 2^n) cast to
  strings, numeric values in [0, 100), random length-8 strings.
* :func:`make_clustered` — the Graphulo-style clustered workload of the
  matmul-strategy benchmark: 8·2^n entries grouped in max(2^(n-7), 4)
  communities of 128×128 keys over a 2^n keyspace, keys zero-padded to 7
  digits so that rank order is numeric order and the communities survive
  rank tiling.  Two independent arrays (A and B) share the generator.

Both reproduce the ``repro`` package's generators draw for draw, so the
two packages see the same arrays at the same n.
"""
from __future__ import annotations

import numpy as np

ENTRIES_PER_ROW = 8             # ≈ 8 nonempty entries per row
SEED = 20220926                 # HPEC'22 publication date


def make_dataset(n: int, seed: int = SEED):
    """Returns dict with rows/rows2/cols/cols2/num_vals/str_vals for size n."""
    rng = np.random.default_rng(seed + n)
    m = ENTRIES_PER_ROW * (2 ** n)

    def ints():
        return rng.integers(0, 2 ** n, size=m)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))

    def strs():
        idx = rng.integers(0, 26, size=(m, 8))
        return np.array(["".join(row) for row in letters[idx]])
    return {
        "rows": ints().astype(str),
        "rows2": ints().astype(str),
        "cols": ints().astype(str),
        "cols2": ints().astype(str),
        "num_vals": rng.integers(0, 100, size=m).astype(np.float64),
        "str_vals": strs(),
    }


def make_clustered(n: int, seed: int = 77):
    """Clustered (community-structured) key pairs for two arrays of size n.

    Returns ``(rows, cols, rows2, cols2)``, each 8·2^n zero-padded decimal
    strings; the values of the benchmark are all 1.0.
    """
    rng = np.random.default_rng(seed + n)
    m = ENTRIES_PER_ROW * 2 ** n

    def pad(a):
        return np.char.zfill(a.astype(str), 7)

    nb = max(2 ** n // 128, 1)           # 128-key blocks in the keyspace
    n_clusters = max(2 ** (n - 7), 4)

    def clustered():
        cr = rng.integers(0, nb, n_clusters)
        cc = rng.integers(0, nb, n_clusters)
        pick = rng.integers(0, n_clusters, m)
        r = cr[pick] * 128 + rng.integers(0, 128, m)
        c = cc[pick] * 128 + rng.integers(0, 128, m)
        return pad(r), pad(c)

    rows, cols = clustered()
    rows2, cols2 = clustered()
    return rows, cols, rows2, cols2
