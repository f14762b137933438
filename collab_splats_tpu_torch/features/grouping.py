"""Gaussian grouping: Gaga-style multi-view object-ID association.

Counterpart of the JAX package's ``features/grouping.py`` (the reference's
``GroupingClassifier``).  Per training view:

  1. segment the view into object masks (features/segmentation.py);
  2. project the Gaussians and, per mask, select the front-most Gaussians
     in each cell of a 32x32 patch grid, so occluded Gaussians do not leak
     into foreground objects;
  3. match each mask's Gaussian set against a memory bank of known objects
     by IoU (greedy best match above a threshold, else a new object id);
  4. update the bank (union) and count per-Gaussian label votes.

Final labels are the per-Gaussian argmax of the votes.  The set algebra
is host numpy over [N] boolean arrays, as in JAX, on
``utils/metrics.py::project_gaussians`` of the ``RenderMeta`` it is given
(which follows that render's device).  The vote table grows by doubling
its columns, where JAX copies it once per new object; its values are the
same.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..ops.rasterize import RenderMeta
from ..utils.metrics import project_gaussians
from .segmentation import Segmentation


@dataclasses.dataclass
class GroupingParams:
    """The reference's GroupingParams."""

    num_patches: int = 32
    front_k_per_patch: int = 4
    iou_threshold: float = 0.25
    confidence_threshold: float = 0.85
    max_objects: int = 255   # uint8 id maps: label+1 must fit in [1, 255]
    min_gaussians_per_mask: int = 5


class GroupingClassifier:
    """Associates persistent object IDs to Gaussians across views."""

    def __init__(self, num_gaussians: int,
                 params: GroupingParams = GroupingParams(),
                 segmentation: Optional[Segmentation] = None):
        self.n = num_gaussians
        self.params = params
        self.segmentation = segmentation or Segmentation()
        # memory bank: [num_objects, N] bool sets
        self.bank: List[np.ndarray] = []
        self._votes = np.zeros((num_gaussians, 0), np.int32)

    @property
    def votes(self) -> np.ndarray:
        """[N, num_objects] int32 label votes (a view of the table)."""
        return self._votes[:, : len(self.bank)]

    # ------------------------------------------------------------ selection
    def select_front_gaussians(
        self,
        mask: np.ndarray,
        proj: Dict[str, np.ndarray],
        height: int,
        width: int,
    ) -> np.ndarray:
        """[N] bool: front-most visible Gaussians per patch inside ``mask``.

        As the reference's select_front_gaussians: bucket the mask's
        Gaussians into a patch grid and keep the k nearest (smallest depth)
        per patch.
        """
        p = self.params
        flat_mask = mask.reshape(-1) > 0
        in_mask = (
            proj["valid_mask"] & flat_mask[proj["proj_flattened"]]
        )
        ids = np.nonzero(in_mask)[0]
        if len(ids) == 0:
            return np.zeros(self.n, bool)
        pix = proj["proj_flattened"][ids]
        depths = proj["proj_depths"][ids]
        ys, xs = pix // width, pix % width
        ph = -(-height // p.num_patches)
        pw = -(-width // p.num_patches)
        patch = (ys // ph) * p.num_patches + (xs // pw)

        out = np.zeros(self.n, bool)
        order = np.lexsort((depths, patch))
        patch_sorted = patch[order]
        # Rank within each patch (stable, depth-ascending).
        starts = np.r_[True, patch_sorted[1:] != patch_sorted[:-1]]
        group_start = np.maximum.accumulate(
            np.where(starts, np.arange(len(order)), 0)
        )
        rank = np.arange(len(order)) - group_start
        keep = order[rank < p.front_k_per_patch]
        out[ids[keep]] = True
        return out

    # ------------------------------------------------------------ matching
    def _assign_label(self, gset: np.ndarray) -> int:
        """Greedy IoU match against the memory bank; a new id below the
        threshold."""
        best_iou, best = 0.0, -1
        for i, bset in enumerate(self.bank):
            inter = np.count_nonzero(gset & bset)
            union = np.count_nonzero(gset | bset)
            iou = inter / union if union else 0.0
            if iou > best_iou:
                best_iou, best = iou, i
        if best >= 0 and best_iou >= self.params.iou_threshold:
            return best
        if len(self.bank) >= self.params.max_objects:
            return best if best >= 0 else 0
        self.bank.append(gset.copy())
        if len(self.bank) > self._votes.shape[1]:
            grown = np.zeros((self.n, max(8, 2 * self._votes.shape[1])),
                             np.int32)
            grown[:, : self._votes.shape[1]] = self._votes
            self._votes = grown
        return len(self.bank) - 1

    def _update_memory_bank(self, label: int, gset: np.ndarray) -> None:
        self.bank[label] |= gset

    # ------------------------------------------------------------ associate
    def associate(
        self,
        image: np.ndarray,
        meta: RenderMeta,
        composite_mask: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Process one view; returns the matched-label mask [H, W] uint8."""
        h, w = meta.height, meta.width
        if composite_mask is None:
            composite_mask = self.segmentation.composite(
                image, self.params.confidence_threshold
            )
        proj = project_gaussians(meta)
        mask_ids = np.unique(composite_mask)
        mask_ids = mask_ids[mask_ids > 0]
        labels = []
        for mid in mask_ids:
            gset = self.select_front_gaussians(
                composite_mask == mid, proj, h, w
            )
            if np.count_nonzero(gset) < self.params.min_gaussians_per_mask:
                labels.append(-1)
                continue
            label = self._assign_label(gset)
            self._update_memory_bank(label, gset)
            self.votes[gset, label] += 1
            labels.append(label)
        matched = np.zeros((h, w), np.uint8)
        for mid, label in zip(mask_ids, labels):
            if label >= 0:
                matched[composite_mask == mid] = label + 1
        return matched

    # -------------------------------------------------------------- labels
    def gaussian_labels(self, min_votes: int = 1) -> np.ndarray:
        """[N] int labels (-1 = unassigned): argmax of accumulated votes."""
        if self.votes.shape[1] == 0:
            return np.full(self.n, -1, np.int64)
        best = self.votes.argmax(axis=1)
        n_votes = self.votes.max(axis=1)
        return np.where(n_votes >= min_votes, best, -1)

    @property
    def num_objects(self) -> int:
        return len(self.bank)
