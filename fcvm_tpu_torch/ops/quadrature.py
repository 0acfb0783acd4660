"""Gauss quadrature tables (reference: ``source code/fcVM.py:586-613``).

Module-level numpy constants; the element kernels turn them into tensors of
the working dtype.  Values match the reference digit for digit.
"""

from __future__ import annotations

import numpy as np

# 4-point rule for the 10-node tetrahedron: (xi, eta, zeta, weight).
GP10 = np.array(
    [
        [0.138196601125011, 0.138196601125011, 0.138196601125011, 0.041666666666667],
        [0.585410196624968, 0.138196601125011, 0.138196601125011, 0.041666666666667],
        [0.138196601125011, 0.585410196624968, 0.138196601125011, 0.041666666666667],
        [0.138196601125011, 0.138196601125011, 0.585410196624968, 0.041666666666667],
    ]
)

# 6-point rule for the 6-node triangle: (xi, eta, weight).
GP6 = np.array(
    [
        [0.445948490915965, 0.445948490915965, 0.111690794839005],
        [0.10810301816807, 0.445948490915965, 0.111690794839005],
        [0.445948490915965, 0.10810301816807, 0.111690794839005],
        [0.091576213509771, 0.091576213509771, 0.054975871827661],
        [0.816847572980458, 0.091576213509771, 0.054975871827661],
        [0.091576213509771, 0.816847572980458, 0.054975871827661],
    ]
)

# 2-point rule for the 3-node line: (xi, weight).
GP2 = np.array([[-0.5773502691896257, 1.0], [0.5773502691896257, 1.0]])
