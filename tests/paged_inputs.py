"""Paged-pool test inputs shared by the port's CPU and card tests (numpy
only: the card tests run where jax is not installed)."""

import numpy as np


def pool_state(seed, B, KVH, d, BLK, MB, L, fills, inactive=(), q_off=0):
    """A pool whose rows hold ``fills`` tokens in shuffled physical blocks,
    with a spare reserved block per row, a sentinel table entry inside
    row 2, and an all -1 block inside row 1; row b's query sits at
    position fills[b] + q_off (-1 for ``inactive`` rows)."""
    rng = np.random.default_rng(seed)
    NB = B * MB
    free = list(rng.permutation(NB))
    table = np.full((B, MB), NB, np.int32)
    pos = np.full((NB, BLK), -1, np.int32)
    q_pos = np.zeros((B,), np.int32)
    for b, f in enumerate(fills):
        n = min(MB, -(-f // BLK) + 1)
        for j in range(n):
            blk = free.pop()
            table[b, j] = blk
            m = max(0, min(BLK, f - j * BLK))
            pos[blk, :m] = np.arange(j * BLK, j * BLK + m)
        q_pos[b] = -1 if b in inactive else f + q_off
    if B > 2:
        table[2, 2:] = np.concatenate([[NB], table[2, 2:-1]])
    if B > 1 and table[1, 2] < NB:
        pos[table[1, 2]] = -1
    k = rng.standard_normal((L, KVH, NB, BLK, d)).astype(np.float32)
    v = rng.standard_normal((L, KVH, NB, BLK, d)).astype(np.float32)
    return k, v, pos, table, q_pos
