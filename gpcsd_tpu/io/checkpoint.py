"""Checkpoint/resume: reference-compatible param pickles + sampler state.

Two tiers (SURVEY.md §5 "Checkpoint / resume"):

1. **Parameter dicts** — the reference persists fitted hyperparameters as
   pickled dicts (``gpcsd1d.py:84-102``; used with reload/refit flags in
   every workload, e.g. ``fit_gpcsd_baseline.py:91-100``).  Our model
   classes emit the *same schema*, so :func:`save_params`/
   :func:`load_params` interoperate with pickles produced by the reference.

2. **Sampler state** — NUTS/SMC runs are resumable: positions, step size,
   mass matrix, and the RNG key are a pytree checkpointed with orbax (or a
   .npz fallback when orbax is unavailable).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np


def save_params(model, path):
    """Pickle a model's parameter dict in the reference schema."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(model.extract_model_params(), f)


def load_params(model, path):
    """Restore parameters from a (reference-compatible) pickle."""
    with open(path, "rb") as f:
        model.restore_model_params(pickle.load(f))
    return model


# ---------------------------------------------------------------------------
# sampler state
# ---------------------------------------------------------------------------


def _to_numpy_tree(tree) -> Dict[str, Any]:
    import jax

    flat, treedef = jax.tree_util.tree_flatten(tree)
    return {
        "leaves": [np.asarray(leaf) for leaf in flat],
        "treedef": treedef,
    }


def save_sampler_state(state, path, backend="auto"):
    """Checkpoint an arbitrary sampler-state pytree.

    :param backend: "auto" uses orbax if importable (production path), else
        .npz + pickled treedef; "npz" forces the treedef-preserving path —
        required when the state contains NamedTuples that must survive a
        round-trip without a ``like`` template (orbax restores plain dicts).
    """
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if backend == "auto":
        try:
            import orbax.checkpoint as ocp

            ckptr = ocp.PyTreeCheckpointer()
            ckptr.save(path, state, force=True)
            return "orbax"
        except Exception:
            pass
    import jax

    flat, treedef = jax.tree_util.tree_flatten(state)
    # Atomic write: a crash mid-save (the scenario this checkpoint
    # exists for) must never leave a truncated .npz or a
    # treedef/npz mismatch.  Both files go to temps and are os.replace()d;
    # the .npz lands LAST because its existence is what gates resume.
    tmp_treedef = path + ".treedef.pkl.tmp"
    tmp_npz = path + ".npz.tmp"
    with open(tmp_treedef, "wb") as f:
        pickle.dump(treedef, f)
    with open(tmp_npz, "wb") as f:
        np.savez(f, **{str(i): np.asarray(l) for i, l in enumerate(flat)})
    os.replace(tmp_treedef, path + ".treedef.pkl")
    os.replace(tmp_npz, path + ".npz")
    return "npz"


def load_sampler_state(path, like=None):
    """Restore a sampler-state pytree saved by :func:`save_sampler_state`."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        import orbax.checkpoint as ocp

        ckptr = ocp.PyTreeCheckpointer()
        return ckptr.restore(path, item=like)
    import jax

    with open(path + ".treedef.pkl", "rb") as f:
        treedef = pickle.load(f)
    data = np.load(path + ".npz")
    leaves = [data[str(i)] for i in range(len(data.files))]
    return jax.tree_util.tree_unflatten(treedef, leaves)
