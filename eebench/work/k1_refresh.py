"""K1's GMM target refresh (``k1_refresh`` + ``k1_finish``), one launch a
tick: phi_k of every scenario's mixture over the shared lattice.

Counted from the algorithm: for each (scenario, lattice point) the mixture's
density, 14 operations a component (the offset, the quadratic form with the
precision matrix, the scale, the exp, the weight and the sum), the mass sum
(1) and the free-space mask (1). The lattice is a tensor product of its x
and y samples, and the basis function a product of a cosine in x and one in
y, so the contraction with the basis is separable, as M's and K3's are
counted: 2 K per lattice point (the x cosines) and 2 K^2 per lattice row
(the y cosines); per scenario the normalisation (2 K^2: h_k and the mass).
Bytes: the mixtures, the lattice's x and y samples, the mask, the two
cosine tables, h_k, the fallback and phi_k once each. The lattice is the
configured N points, not a kernel's padded count, and no kernel's table
(such as a dense N x K^2 one) is counted, so a kernel's layout, padding or
tiling moves neither number.
"""


def count(cfg: dict, S: int, facts: dict):
    K = cfg["num_basis"]
    KK = K * K
    nsx, nsy = cfg["grid_samples"]
    N = nsx * nsy
    J = facts["gmm_components"]
    flops = S * (N * (14 * J + 2 + 2 * K) + nsy * 2 * KK + 2 * KK)
    nbytes = 4 * (S * J * 7 + nsx + nsy + N + (nsx + nsy) * K + 2 * KK + S * KK)
    return flops, nbytes
