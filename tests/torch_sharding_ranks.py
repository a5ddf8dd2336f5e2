"""The ranks of tests/test_torch_sharding.py: a ``torch.distributed`` world of
spawned processes (gloo, a ``file://`` rendezvous) that runs every sharded
case of ``elimaloc_tpu_torch.parallel`` and writes each rank's results to a
file. It imports torch, NumPy and the port, never JAX.

``run_world(inputs, tmp, world, device)`` saves ``inputs`` (a dict of the
port's records, see :func:`rank_main`), starts ``world`` ranks under the
``spawn`` start method (:func:`start_world`; :func:`finish_world` waits)
and returns their results, one dict a rank:
``{case: {"out": NumPy tree, "collectives": counts, "launches": kernel
launch counts, "seconds": wall clock}}``, or for a refusal
``{case: {"error": (type name, message)}}``. Each rank sets one intra-op
thread, makes the meshes ``make_mesh(world, dp=1)`` (sp), ``dp=world`` (dp)
and ``dp=2`` (2 x world/2; 1 x world for an odd world), moves the inputs
to its device through
``replicate`` and runs the cases in the order given.
"""

from __future__ import annotations

import dataclasses
import datetime
import time
from pathlib import Path

import torch
import torch.distributed as dist

#: seconds a rank waits in a collective, and the world's whole deadline
COLLECTIVE_TIMEOUT_S = 120
WORLD_DEADLINE_S = 600


def numpy_tree(tree):
    """A record / dict / tensor as nested dicts of NumPy arrays."""
    if dataclasses.is_dataclass(tree):
        return {f.name: numpy_tree(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _run_case(case, inp, meshes):
    """One case of ``inp["cases"]`` on this rank -> its output record."""
    from elimaloc_tpu_torch import parallel
    from elimaloc_tpu_torch.parallel import sharding
    from elimaloc_tpu_torch.register import icp

    kind = case["kind"]
    get = inp.__getitem__
    if kind == "point":
        return parallel.register_sharded(get(case["scan"]), get(case["valid"]), get(case["map"]),
                                         get(case["init"]), get(case["params"]), case["static"],
                                         meshes["sp"], "sp")
    if kind == "slot":
        static = dataclasses.replace(case["static"], slot_shard_axis="sp")
        with sharding.use_mesh(meshes["sp"]):
            return icp.run_register(get(case["scan"]), get(case["valid"]), get(case["map"]),
                                    get(case["init"]), get(case["params"]), static)
    if kind == "dp":
        return parallel.register_batch_dp(get(case["scan"]), get(case["valid"]),
                                          get(case["map"]), get(case["init"]),
                                          get(case["params"]), case["static"], meshes["dp"])
    if kind == "2d":
        return parallel.register_batch_2d(get(case["scan"]), get(case["valid"]),
                                          get(case["map"]), get(case["init"]),
                                          get(case["params"]), case["static"], meshes["2d"])
    replay = {"replay_sp": (parallel.replay_fused_sp, "sp"),
              "replay_dp": (parallel.replay_fused_dp, "dp"),
              "replay_2d": (parallel.replay_fused_2d, "2d")}
    if kind in replay:
        fn, mesh = replay[kind]
        return fn(get(case["state"]), get(case["batches"]), get(case["map"]), get(case["pp"]),
                  case["ps"], meshes[mesh])
    if kind == "unbound":
        static = dataclasses.replace(case["static"], psum_axis="sp")
        return icp.run_register(get(case["scan"]), get(case["valid"]), get(case["map"]),
                                get(case["init"]), get(case["params"]), static)
    if kind == "world_size":
        return sharding.make_mesh(case["n_devices"], dp=1, device_type=case["device_type"])
    raise ValueError(f"unknown case kind {kind!r}")


def rank_main(rank, world, in_path, out_dir, init_file, device, backend="gloo"):
    """One rank. ``inputs``: ``{"cases": [(name, case dict), ...], "refusals":
    [names], **records}``: each case names its inputs by their keys in the
    dict (``scan``, ``valid``, ``map``, ``init``, ``params``; ``state``,
    ``batches``, ``pp`` for replays) and carries its static (``static`` /
    ``ps``) and ``kind``: "point" (``register_sharded``, sp = world),
    "slot" (``run_register`` with ``slot_shard_axis``), "dp"
    (``register_batch_dp``), "2d" (``register_batch_2d``), "replay_sp",
    "replay_dp", "replay_2d", or the refusals "unbound" (a ``psum_axis``
    registration with no active mesh) and "world_size"."""
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        from elimaloc_tpu_torch import kernels
        from elimaloc_tpu_torch.parallel import sharding

        meshes = {"sp": sharding.make_mesh(world, dp=1, device_type=device),
                  "dp": sharding.make_mesh(world, dp=world, device_type=device),
                  "2d": sharding.make_mesh(world, dp=2 if world % 2 == 0 else 1,
                                           device_type=device)}
        raw = torch.load(in_path, weights_only=False)
        cases = raw.pop("cases")
        inp = sharding.replicate(raw, meshes["sp"])
        results = {}
        for name, case in cases:
            sharding.reset_collectives()
            kernels.reset_launches()
            t0 = time.time()
            try:
                out = _run_case(case, inp, meshes)
            except (NameError, ValueError) as e:
                if not case.get("refusal"):
                    raise
                results[name] = {"error": (type(e).__name__, str(e))}
                continue
            if device == "cuda":
                torch.cuda.synchronize()
            results[name] = {"out": numpy_tree(out), "collectives": dict(sharding.collectives),
                             "launches": {k: v for k, v in kernels.launches.items() if v},
                             "seconds": time.time() - t0}
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def to_device(tree, device):
    """A record / dict / tensor with every tensor moved to ``device``."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: to_device(getattr(tree, f.name), device)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def start_world(inputs, tmp, world=4, device="cpu", backend="gloo"):
    """Save ``inputs`` under ``tmp`` and start ``world`` spawned ranks on
    them; returns the handle :func:`finish_world` takes."""
    import torch.multiprocessing as mp

    tmp = Path(tmp)
    in_path = tmp / "inputs.pt"
    torch.save(inputs, in_path)
    ctx = mp.start_processes(rank_main, args=(world, str(in_path), str(tmp),
                                              str(tmp / "rendezvous"), device, backend),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, tmp, world, time.time() + WORLD_DEADLINE_S


def stop_world(handle):
    """Stop every rank of the world that is still running."""
    for p in handle[0].processes:
        if p.is_alive():
            p.terminate()
            p.join()


def finish_world(handle):
    """Wait for the ranks and return their results (one dict a rank). A rank
    that raises, or a world past :data:`WORLD_DEADLINE_S`, raises here;
    every rank is stopped."""
    ctx, tmp, world, deadline = handle
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                raise TimeoutError(f"the {world}-rank world passed {WORLD_DEADLINE_S} s")
    finally:
        stop_world(handle)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def run_world(inputs, tmp, world=4, device="cpu", backend="gloo"):
    """:func:`start_world` then :func:`finish_world`."""
    return finish_world(start_world(inputs, tmp, world, device, backend))
