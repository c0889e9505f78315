"""matplotlib's "jet" colormap as data: its segment table and the lookup
table matplotlib builds from it (256 entries), so the port needs no
matplotlib."""
import numpy as np

# (x, y0, y1) breakpoints per channel, as matplotlib's _cm.py lists them
_JET_SEGMENTS = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0), (1, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1, 0, 0)),
}


def _lookup_table(n: int, segments) -> np.ndarray:
    """matplotlib.colors._create_lookup_table at gamma 1."""
    adata = np.array(segments)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


JET_256 = np.stack([_lookup_table(256, _JET_SEGMENTS[c]) for c in ("red", "green", "blue")], axis=-1)
