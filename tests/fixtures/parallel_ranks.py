"""Rank functions of the port's data-parallel CPU tests.

``parallel.launch`` starts each rank in a fresh process (``spawn``) and
calls a function of an importable module, so the functions live here, in
a module that imports only the port (no JAX): each rank builds its state
from numpy trees made in the test's process, runs the cases, and rank 0
returns what every case produced.  Per step, every rank's parameters are
hashed and the hashes gathered, so the tests can check that the replicas
stay bit-equal.
"""

import hashlib

import torch
import torch.distributed as dist

from captionax_torch.core import config as tconfig
from captionax_torch.interop import from_jax_params, to_numpy_tree
from captionax_torch.parallel import make_mesh, replicate_params, shard_batch
from captionax_torch.train import harness as tharness
from captionax_torch.train import steps as tsteps
from captionax_torch.train.state import create_train_state, make_optimizer, tree_leaves


def digest(tree) -> str:
    h = hashlib.sha256()
    for x in tree_leaves(tree):
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def every_rank(value) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def step_case(mesh, case) -> dict:
    """Train steps through ``jit_data_parallel`` on this rank's shards."""
    dev = mesh.local_device
    tx = make_optimizer(case["lr"])
    make = tsteps.make_gru_steps if case["kind"] == "gru" else tsteps.make_hypernet_steps
    train, _ = make(tx, fused_scan=case["fused"])
    pstep = tsteps.jit_data_parallel(train, mesh)
    params = replicate_params(mesh, from_jax_params(case["params"], device=dev))
    state = create_train_state(params, tx, device=dev)
    losses, digests = [], []
    for i, batch in enumerate(case["batches"]):
        local = shard_batch(mesh, batch)
        if case.get("poison") == (mesh.rank, i):
            local["features"] = local["features"].clone()
            local["features"][0, 0, 0] = float("nan")
        state, metrics = pstep(state, local)
        losses.append(float(metrics["train_loss"]))
        digests.append(every_rank(digest(state.params)))
    return {"losses": losses, "digests": digests, "params": to_numpy_tree(state.params),
            "skipped": int(state.opt_state.total_notfinite),
            "adam_count": int(state.opt_state.adam.count)}


def harness_case(mesh, case) -> dict:
    """``CaptionTrainer(mesh=...).fit`` for the case's epochs, then
    ``test_beam`` on the validation batches."""
    cfg = tconfig.TrainConfig(**case["config"])
    clf = case.get("classifier")
    trainer = tharness.CaptionTrainer(
        from_jax_params(case["params"], device="cpu"), case["kind"], cfg, case["vocab"],
        mesh=mesh, run_name="run",
        style_classifier_params=None if clf is None else from_jax_params(clf, device="cpu"))
    hist = trainer.fit(lambda epoch: case["train"][epoch], lambda: case["val"])
    beam = trainer.test_beam(case["val"])
    return {"history": hist, "beam": beam, "digests": every_rank(digest(trainer.params)),
            "params": to_numpy_tree(trainer.params)}


def train_world(cases: dict) -> dict:
    """Run every case on this rank; -> {name: result}."""
    torch.set_num_threads(1)
    mesh = make_mesh(devices=["cpu"] * dist.get_world_size())
    out = {}
    for name, case in cases.items():
        run = harness_case if "config" in case else step_case
        out[name] = run(mesh, case)
    out["world"] = {"size": dist.get_world_size(), "backend": dist.get_backend(),
                    "devices": [str(d) for d in mesh.data_devices]}
    return out


def fail_on_rank_1():
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()
