"""Exact reranking of the upper-bound scan's candidate lists.

Port of ``falcon_tpu/ops/rerank.py``: every (query, candidate) pair of the
lists is scored with the exact peak-matching cosine and each row keeps its
top ``k_out``, so density clustering runs on exact distances.  The scoring
is the pair-list kernel of ``ops/pairwise.py`` (``pair_list_scores``; the
JAX package's XLA ``rerank_scan_body`` gathers the candidates' peaks and
builds their (P, P) weights instead); the top-k is ``stable_topk``, ties to
the lower slot as ``lax.top_k`` breaks them.  The candidates' pool is the
block itself, or, on a shard of the sharded pipeline, the shard's halo
(``pool``): the kernel takes the queries and the pool apart.
``rerank_scan_body`` is the plain version, on ``pair_list_scores_plain``.
"""

from typing import Optional, Tuple

import torch

from . import pairwise
from .knn import NEG, stable_topk


def _keep_top(scores: torch.Tensor, matches: torch.Tensor,
              neigh: torch.Tensor, k_out: int) -> Tuple[torch.Tensor,
                                                        torch.Tensor,
                                                        torch.Tensor]:
    top, pos = stable_topk(scores, k_out)
    ids = torch.where(top > NEG, torch.gather(neigh, 1, pos), -1)
    return top, ids, torch.gather(matches, 1, pos)


def rerank_exact(
    mz_pad: torch.Tensor,
    int_pad: torch.Tensor,
    neigh: torch.Tensor,
    fragment_tol: float,
    k_out: int,
    rounds: int = 4,
    pool: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact-score the candidate lists and keep each row's top ``k_out``.

    ``mz_pad``/``int_pad``: the (n_pad, P) padded peaks of the queries,
    which are also the candidate pool unless ``pool`` gives its (n_pool,
    P) m/z and intensities; ``neigh``: (n_pad, K) int64 pool ids, -1 =
    missing.  Returns (scores float32, ids int64, matches
    int32), each (n_pad, min(k_out, K)), ordered by exact score; a slot
    not above ``NEG`` has id -1.  Four matching rounds, as the JAX
    package's default (its scores measured identical to eight rounds on
    the bench corpus).
    """
    k_out = min(int(k_out), neigh.shape[1])
    pool_mz, pool_int = (mz_pad, int_pad) if pool is None else pool
    scores, matches = pairwise.pair_list_scores(
        mz_pad, int_pad, pool_mz, pool_int, neigh.contiguous(), fragment_tol,
        rounds)
    return _keep_top(scores, matches, neigh, k_out)


def rerank_scan_body(
    mz: torch.Tensor,
    intensity: torch.Tensor,
    pool_mz: torch.Tensor,
    pool_int: torch.Tensor,
    neigh: torch.Tensor,
    fragment_tol: float,
    k_out: int,
    rounds: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`rerank_exact` (any device), with the
    queries and the pool apart as in the JAX package."""
    k_out = min(int(k_out), neigh.shape[1])
    scores, matches = pairwise.pair_list_scores_plain(
        mz, intensity, pool_mz, pool_int, neigh, fragment_tol, rounds)
    return _keep_top(scores, matches, neigh, k_out)
