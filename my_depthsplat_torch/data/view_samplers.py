"""View samplers: choose context/target frame indices per scene.

The port's own copy of my_depthsplat_tpu/data/view_samplers.py: a
re-design of src/dataset/view_sampler/* in pure numpy with explicit RNG and an
explicit ``global_step`` argument (replacing the shared-memory StepTracker —
the trainer simply passes its step into the loader each epoch):

- bounded:      random context gap with warm-up schedule, targets inside
                (view_sampler_bounded.py:24-132)
- boundedv2:    variable context count, targets may fall outside the context
                window by a scheduled margin, extra views via random /
                farthest-point selection (view_sampler_bounded_v2.py:16-253)
- evaluation:   frozen JSON index (view_sampler_evaluation.py:24-62)
- arbitrary:    fixed or fully random indices
- all:          every view as both context and target
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Literal, Optional

import numpy as np

Stage = Literal["train", "val", "test"]


class SkipExample(ValueError):
    """Raised when an example can't satisfy the sampler's constraints."""


def farthest_point_sample(xyz: np.ndarray, npoint: int) -> np.ndarray:
    """(N, 3) -> (npoint,) farthest-point-sampling indices, seeded from the
    point farthest from the barycenter (view_sampler_bounded_v2.py:16-49)."""
    n = xyz.shape[0]
    centroids = np.zeros(npoint, dtype=np.int64)
    distance = np.full(n, 1e10)
    barycenter = xyz.mean(axis=0, keepdims=True)
    farthest = int(np.argmax(((xyz - barycenter) ** 2).sum(-1)))
    for i in range(npoint):
        centroids[i] = farthest
        d = ((xyz - xyz[farthest][None]) ** 2).sum(-1)
        distance = np.minimum(distance, d)
        farthest = int(np.argmax(distance))
    return centroids


def resolve_step(global_step) -> int:
    """Accepts an int or a zero-arg callable returning the live step.

    The driver passes a callable so the curriculum advances with training
    (the reference publishes the live step via StepTracker shared memory,
    src/model/model_wrapper.py:371-373 + view_sampler.py:57-59)."""
    return int(global_step()) if callable(global_step) else int(global_step)


def _schedule(initial: int, final: int, step: int, warm_up: int) -> int:
    if warm_up <= 0:
        return final
    frac = step / warm_up
    return min(initial + int((final - initial) * frac), final)


@dataclass(frozen=True)
class ViewSamplerBounded:
    num_context_views: int = 2
    num_target_views: int = 4
    min_distance_between_context_views: int = 45
    max_distance_between_context_views: int = 45
    min_distance_to_context_views: int = 0
    warm_up_steps: int = 0
    initial_min_distance_between_context_views: int = 25
    initial_max_distance_between_context_views: int = 25
    stage: Stage = "train"
    cameras_are_circular: bool = False

    def sample(
        self,
        scene: str,
        extrinsics: np.ndarray,
        intrinsics: np.ndarray,
        rng: np.random.Generator,
        global_step: int = 0,
    ) -> tuple[np.ndarray, np.ndarray]:
        global_step = resolve_step(global_step)
        num_views = extrinsics.shape[0]
        if self.stage == "test":
            min_gap = max_gap = self.max_distance_between_context_views
        else:
            max_gap = _schedule(
                self.initial_max_distance_between_context_views,
                self.max_distance_between_context_views,
                global_step,
                self.warm_up_steps,
            )
            min_gap = _schedule(
                self.initial_min_distance_between_context_views,
                self.min_distance_between_context_views,
                global_step,
                self.warm_up_steps,
            )
        if not self.cameras_are_circular:
            max_gap = min(num_views - 1, max_gap)
        min_gap = max(2 * self.min_distance_to_context_views, min_gap)
        if max_gap < min_gap:
            raise SkipExample("Example does not have enough frames!")

        gap = int(rng.integers(min_gap, max_gap + 1))
        left_hi = num_views if self.cameras_are_circular else num_views - gap
        left = int(rng.integers(left_hi))
        if self.stage == "test":
            left = 0
        right = left + gap

        if self.stage == "test":
            target = np.arange(left, right + 1)
        else:
            target = rng.integers(
                left + self.min_distance_to_context_views,
                right + 1 - self.min_distance_to_context_views,
                size=self.num_target_views,
            )
        if self.cameras_are_circular:
            target = target % num_views
            right = right % num_views
        return np.array([left, right], np.int64), target.astype(np.int64)


@dataclass(frozen=True)
class ViewSamplerBoundedV2:
    num_context_views: int = 2
    num_target_views: int = 4
    min_distance_between_context_views: int = 45
    max_distance_between_context_views: int = 45
    max_distance_to_context_views: int = 0
    context_gap_warm_up_steps: int = 0
    target_gap_warm_up_steps: int = 0
    initial_min_distance_between_context_views: int = 25
    initial_max_distance_between_context_views: int = 25
    initial_max_distance_to_context_views: int = 0
    extra_views_sampling_strategy: str = "random"  # or farthest_point
    target_views_replace_sample: bool = True
    stage: Stage = "train"
    cameras_are_circular: bool = False

    def sample(
        self,
        scene: str,
        extrinsics: np.ndarray,
        intrinsics: np.ndarray,
        rng: np.random.Generator,
        global_step: int = 0,
        max_num_views: Optional[int] = None,
        min_context_views: int = 0,
        max_context_views: int = 0,
    ) -> tuple[np.ndarray, np.ndarray]:
        global_step = resolve_step(global_step)
        num_views = extrinsics.shape[0]
        if max_num_views is not None:
            num_views = min(num_views, max_num_views)

        random_num_views = None
        if min_context_views > 0 and max_context_views > 0 and self.stage != "test":
            random_num_views = int(
                rng.integers(min_context_views, max_context_views + 1)
            )

        if self.stage == "test":
            min_gap = max_gap = self.max_distance_between_context_views
        else:
            max_gap = _schedule(
                self.initial_max_distance_between_context_views,
                self.max_distance_between_context_views,
                global_step,
                self.context_gap_warm_up_steps,
            )
            min_gap = _schedule(
                self.initial_min_distance_between_context_views,
                self.min_distance_between_context_views,
                global_step,
                self.context_gap_warm_up_steps,
            )
        if random_num_views is not None:
            scale = max(max_context_views // random_num_views, 1)
            max_gap //= scale
            min_gap //= scale
        if not self.cameras_are_circular:
            max_gap = min(num_views - 1, max_gap)

        if self.stage != "test" and self.target_gap_warm_up_steps > 0:
            max_target_gap = _schedule(
                self.initial_max_distance_to_context_views,
                self.max_distance_to_context_views,
                global_step,
                self.target_gap_warm_up_steps,
            )
        else:
            max_target_gap = self.max_distance_to_context_views

        if max_gap < min_gap:
            raise SkipExample("Example does not have enough frames!")
        gap = int(rng.integers(min_gap, max_gap + 1))
        left_hi = num_views if self.cameras_are_circular else num_views - gap
        left = int(rng.integers(left_hi))
        if self.stage == "test":
            left = 0
        right = left + gap

        t_left = left - max_target_gap
        t_right = right + max_target_gap
        if not self.cameras_are_circular:
            t_left = max(0, t_left)
            t_right = min(num_views - 1, t_right)

        if self.stage == "test":
            target = np.arange(t_left, t_right + 1)
        elif self.target_views_replace_sample:
            target = rng.integers(t_left, t_right + 1, size=self.num_target_views)
        else:
            candidates = np.arange(t_left, t_right + 1)
            target = candidates[
                rng.permutation(len(candidates))[: self.num_target_views]
            ]
        if self.cameras_are_circular:
            target = target % num_views
            right = right % num_views

        total = (
            random_num_views if random_num_views is not None else self.num_context_views
        )
        extra: list[int] = []
        if total > 2:
            n_extra = total - 2
            if self.extra_views_sampling_strategy == "farthest_point":
                span = np.arange(left, right + 1)
                pos = extrinsics[span, :3, 3]
                local = farthest_point_sample(pos, total)
                chosen = span[local]
                left, right = int(chosen[0]), int(chosen[-1])
                extra = sorted(int(i) for i in chosen[1:-1])
            else:  # random distinct in (left, right)
                if right - left - 1 < n_extra:
                    raise SkipExample("Not enough frames for extra context views")
                extra = sorted(
                    int(i)
                    for i in rng.choice(
                        np.arange(left + 1, right), size=n_extra, replace=False
                    )
                )
        return (
            np.array([left, *extra, right], np.int64),
            target.astype(np.int64),
        )


@dataclass(frozen=True)
class ViewSamplerEvaluation:
    """Frozen evaluation index: scene -> {context: [...], target: [...]}."""

    index_path: Path = Path("assets/evaluation_index_re10k.json")
    num_context_views: int = 2
    stage: Stage = "test"

    def _index(self):
        if not hasattr(self, "_cache"):
            with open(self.index_path) as f:
                object.__setattr__(self, "_cache", json.load(f))
        return self._cache

    def sample(self, scene, extrinsics, intrinsics, rng=None, global_step=0):
        entry = self._index().get(scene)
        if entry is None:
            raise SkipExample(f"No evaluation index entry for scene {scene}")
        return (
            np.asarray(entry["context"], np.int64),
            np.asarray(entry["target"], np.int64),
        )


@dataclass(frozen=True)
class ViewSamplerArbitrary:
    num_context_views: int = 2
    num_target_views: int = 4
    context_views: Optional[tuple[int, ...]] = None
    target_views: Optional[tuple[int, ...]] = None
    stage: Stage = "train"

    def sample(self, scene, extrinsics, intrinsics, rng, global_step=0):
        num_views = extrinsics.shape[0]
        if self.context_views is not None:
            context = np.asarray(self.context_views, np.int64)
        else:
            context = rng.integers(num_views, size=self.num_context_views)
        if self.target_views is not None:
            target = np.asarray(self.target_views, np.int64)
        else:
            target = rng.integers(num_views, size=self.num_target_views)
        return context.astype(np.int64), target.astype(np.int64)


@dataclass(frozen=True)
class ViewSamplerAll:
    stage: Stage = "test"

    def sample(self, scene, extrinsics, intrinsics, rng=None, global_step=0):
        v = extrinsics.shape[0]
        allv = np.arange(v, dtype=np.int64)
        return allv, allv


_REGISTRY = {
    "bounded": ViewSamplerBounded,
    "boundedv2": ViewSamplerBoundedV2,
    "evaluation": ViewSamplerEvaluation,
    "arbitrary": ViewSamplerArbitrary,
    "all": ViewSamplerAll,
}


def get_view_sampler(name: str, **kwargs):
    return _REGISTRY[name](**kwargs)
