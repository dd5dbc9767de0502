"""Instance clustering — the LBVH analog behind the accel API.

The reference leans on driver-built BVHs (BLAS/TLAS,
/root/reference/src/Renderer.cpp:616-730) so traversal skips geometry
whose bounds a ray misses. The replacement here is NOT a per-ray stack
walk (lane-divergent, gather-heavy); it is a **two-level bounds hierarchy
meant to be evaluated per tile**: instances are grouped host-side into
spatial clusters by recursive median split (the classic LBVH build
collapsed to its leaf cut), each cluster gets a merged AABB, and a tile
that misses a cluster's slab skips all of its members — sublinear
effective work in instance count for spatially coherent tiles, with zero
per-lane divergence. The builder records the clusters in the layout; the
wavefront traversal (accel/traverse.py) does not consume them yet.

Instance AABBs are static in BLAS space (animation happens inside them via
the per-frame local transforms, Renderer.cpp:302-356), so the build runs
once per scene on the host, like the reference's BLAS build.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

# Closed-form scenes at or below this many instances skip clustering: a
# handful of per-geometry slab gates is cheaper than any hierarchy (the
# 16-instance analytic grid measured faster flat on the previous
# accelerator, because its tiles see most instances anyway).
FLAT_THRESHOLD = 16

# March-kind instances (SDF sphere traces, metaball interval marches) are
# a different economy: every gated-OUT march saves a whole while-loop, so
# clustering pays at much smaller counts (measured on the builtin scene, 8
# march instances of 10, on the previous accelerator). Below this many
# march instances the flat gates win.
MARCH_FLAT_THRESHOLD = 7

# Default leaf width: a tile intersecting a cluster pays all members'
# gates; 8 keeps that cost small while halving 128-instance scenes to 16
# slabs.
DEFAULT_LEAF_SIZE = 8

# Small march-heavy scenes cluster tighter: with ~10 instances a leaf of 4
# still yields 3 slab gates while letting edge tiles skip whole march
# groups (the measured builtin win above used this width).
MARCH_LEAF_SIZE = 4


def build_clusters(
    aabb_min: np.ndarray,
    aabb_max: np.ndarray,
    leaf_size: int = DEFAULT_LEAF_SIZE,
) -> Tuple[Tuple[int, ...], ...]:
    """Recursive median split over AABB centroids; returns per-cluster
    member index tuples (a partition of range(N), each <= leaf_size,
    spatially compact). Deterministic for a given input."""
    aabb_min = np.asarray(aabb_min, dtype=np.float64)
    aabb_max = np.asarray(aabb_max, dtype=np.float64)
    n = aabb_min.shape[0]
    centroids = (aabb_min + aabb_max) * 0.5

    def split(idx: np.ndarray) -> list:
        if idx.size <= leaf_size:
            return [tuple(int(i) for i in idx)]
        spans = centroids[idx].max(axis=0) - centroids[idx].min(axis=0)
        axis = int(np.argmax(spans))
        order = idx[np.argsort(centroids[idx, axis], kind="stable")]
        half = idx.size // 2
        return split(order[:half]) + split(order[half:])

    return tuple(split(np.arange(n)))


def cluster_aabbs(
    clusters: Sequence[Sequence[int]], aabb_min, aabb_max
) -> Tuple[np.ndarray, np.ndarray]:
    """Merged AABB per cluster (numpy in / numpy out; also works on traced
    arrays via the jnp fallback in pack-time code)."""
    mins = np.stack([np.min(np.asarray(aabb_min)[list(c)], axis=0) for c in clusters])
    maxs = np.stack([np.max(np.asarray(aabb_max)[list(c)], axis=0) for c in clusters])
    return mins, maxs


def should_cluster(num_instances: int, march_kinds: int = 0) -> bool:
    """Cluster when the instance count clears the closed-form crossover OR
    when enough MARCH instances are present that gating whole groups out
    pays at small counts (see MARCH_FLAT_THRESHOLD). Both thresholds were
    set on the previous accelerator's per-tile traversal."""
    return num_instances > FLAT_THRESHOLD or march_kinds > MARCH_FLAT_THRESHOLD


def leaf_size_for(num_instances: int) -> int:
    """Leaf width policy: small (march-heavy) scenes split tighter so edge
    tiles can skip whole march groups; big scenes keep the wider leaf that
    amortizes slab tests."""
    return MARCH_LEAF_SIZE if num_instances <= FLAT_THRESHOLD else DEFAULT_LEAF_SIZE
