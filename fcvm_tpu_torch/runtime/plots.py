"""Non-interactive analysis curves (the reference's plot window, headless).

The reference pops an interactive matplotlib window mid-analysis with
load-displacement and CSR/PEEQ-vs-LF curves plus elastic-limit and rupture
markers (``source code/fcVM.py:1638-2080``).  Batch runs are headless,
so this renders the same two panels to a PNG; the interactive continue /
add / reverse controls map to the driver's ``continuation`` callback.
The port's copy of :mod:`fcvm_tpu.runtime.plots`.  matplotlib is imported
only inside the writer; without it the writer raises ``ImportError``.
"""

from __future__ import annotations

import numpy as np


def save_curves(path, history, params) -> None:
    """Render load-displacement + damage-vs-LF panels to ``path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    use_csr = params.csr_option == "CSR"
    el_limit, ul_limit = history.limits(params.ultimate_strain, use_csr)

    un = np.asarray(history.un)
    load = np.asarray(history.load)
    csr = np.asarray(history.csr)
    peeqmax = np.asarray(history.peeqmax)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
    ax1.plot(un, load, "-o", ms=3, lw=1)
    ax1.set_xlabel("displacement [mm]")
    ax1.set_ylabel("load factor / reaction")
    ax1.set_title("load - displacement")
    if el_limit > 0:
        ax1.axhline(load[el_limit], color="b", ls="--", lw=0.8, label="elastic limit")
    if ul_limit > 0:
        ax1.axhline(load[ul_limit], color="r", ls="--", lw=0.8, label="ultimate limit")
    if el_limit > 0 or ul_limit > 0:
        ax1.legend(fontsize=8)
    ax1.grid(alpha=0.3)

    ax2.plot(load, csr, "-o", ms=3, lw=1, label="CSR max")
    ax2.plot(load, peeqmax, "-s", ms=3, lw=1, label="PEEQ max")
    ax2.axhline(1.0, color="r", ls=":", lw=0.8)
    ax2.set_xlabel("load factor")
    ax2.set_title("damage vs load factor")
    ax2.legend(fontsize=8)
    ax2.grid(alpha=0.3)

    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
