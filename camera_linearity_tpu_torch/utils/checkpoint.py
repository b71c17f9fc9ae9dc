"""Checkpoint / resume for long-running solves.

Port of ``camera_linearity_tpu/utils/checkpoint.py``: trees of arrays, and
the differential-evolution state (population, energies, the per-channel
generators' states, generation counter and done flags) among them, save
with ``torch.save`` in place of orbax, so a calibration can stop and
continue where it left off.  The reference has no in-process persistence
(SURVEY.md §5).
"""
from __future__ import annotations

import pickle
import zipfile
from pathlib import Path
from typing import Any, List

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree", "DECheckpoint"]

# a numpy array or scalar travels as {_NUMPY: tensor}: the weights-only
# loader takes tensors, not numpy's own pickles
_NUMPY = "__numpy__"


def _encode(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (np.ndarray, np.generic)):
        return {_NUMPY: torch.from_numpy(np.array(tree))}
    if isinstance(tree, dict):
        return {k: _encode(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_encode(v) for v in tree)
    return tree


def _decode(tree: Any) -> Any:
    if isinstance(tree, dict):
        if set(tree) == {_NUMPY}:
            return tree[_NUMPY].numpy()
        return {k: _decode(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_decode(v) for v in tree)
    return tree


def save_pytree(path: str | Path, tree: Any) -> None:
    """Save nested dicts, lists and tuples of tensors, numpy arrays and
    Python scalars to the file ``path`` (tensors on the CPU).  The file is
    written beside ``path`` and renamed over it, so a reader never sees half
    of one."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(_encode(tree), tmp)
    tmp.replace(path)


def load_pytree(path: str | Path) -> Any:
    """The tree :func:`save_pytree` saved, its numpy arrays as numpy and its
    tensors on the CPU; loads tensors and containers only
    (``weights_only``)."""
    return _decode(torch.load(path, map_location="cpu", weights_only=True))


class DECheckpoint:
    """Differential-evolution solver state persistence.

    Stores the (C, S, D) normalized population, (C, S) energies, one
    ``torch.Generator`` state per channel, the generation counter and the
    (C,) done flags: everything ``differential_evolution_batched`` needs to
    continue a solve.  Tensors are saved on the CPU.
    """

    FIELDS = ("pop", "energies", "generator_states", "nit", "done")

    @staticmethod
    def save(path: str | Path, pop, energies,
             generators: List[torch.Generator], nit: int, done) -> None:
        save_pytree(path, {
            "pop": pop, "energies": energies,
            "generator_states": [g.get_state() for g in generators],
            "nit": int(nit), "done": done})

    @staticmethod
    def load(path: str | Path):
        """(pop, energies, generator_states, nit, done), on the CPU."""
        state = load_pytree(path)
        return tuple(state[k] for k in DECheckpoint.FIELDS)

    @staticmethod
    def exists(path: str | Path) -> bool:
        return Path(path).exists()

    @classmethod
    def try_load(cls, path: str | Path):
        """Load a checkpoint, or None when it is absent or unreadable.

        A process killed mid-save can leave a partial or corrupt file:
        resuming then degrades to a fresh start instead of failing, which
        is the recovery the checkpoint exists for.  Structural problems
        (missing fields, inconsistent shapes) count the same way and are
        logged.
        """
        if not cls.exists(path):
            return None
        try:
            state = cls.load(path)
            pop, energies, gen_states = state[:3]
            if pop.ndim != 3 or energies.shape != pop.shape[:2] \
                    or len(gen_states) != pop.shape[0]:
                raise ValueError("checkpoint field shapes inconsistent")
            return state
        except (OSError, EOFError, RuntimeError, ValueError, KeyError,
                TypeError, pickle.UnpicklingError,
                zipfile.BadZipFile) as exc:
            import logging
            logging.getLogger("camera_linearity_tpu_torch").warning(
                "checkpoint at %s unreadable (%s: %s); starting fresh",
                path, type(exc).__name__, str(exc)[:200])
            return None
