"""One rank of a ``tests/test_torch_parallel.py`` world (the port only: no
JAX, one PyTorch thread, gloo on the CPU, rendezvous through a
``file://`` store in the test's temporary directory, never a TCP port).

    python tests/torch_parallel_worker.py <spec.json> <rank>

``spec.json`` (written by the test) names the world's size and store, the
TM-align TSVs (a fit may name its own), the initial weights (``init.pt``;
a fit marked ``seeded`` takes ``DeepBLAST.init()``'s) and what to run, in
order: ``fits`` (``DeepBLAST.fit`` through the port's writers into
``<dir>/<name>``), ``sharded`` (a sharded ``expected_alignment`` and its
gradient), ``shard_params`` (placements on a ``(2, 2)`` mesh) and
``search`` (``cli.search`` in process); then, with the group left,
``search_torchrun`` (``cli.search`` under torchrun's environment and no
process group: the models each rank loaded).  The rank's results go to
``<dir>/result_<rank>.pt``.
"""

import json
import os
import sys
import types

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# tensorboard's own TensorFlow stub, as tests/torch_threads.py sets it
sys.modules.setdefault("tensorboard.compat.notf",
                       types.ModuleType("tensorboard.compat.notf"))

from deepblast_torch.parallel import mesh as mesh_lib  # noqa: E402


def run_fit(spec, fit, out):
    from deepblast_torch.data.dataset import TMAlignDataset
    from deepblast_torch.train.checkpoint import (Checkpointer, save_config,
                                                  save_model)
    from deepblast_torch.train.trainer import DeepBLAST, DeepBLASTConfig
    from deepblast_torch.utils.logging import MetricsLogger
    model = DeepBLAST(DeepBLASTConfig(**fit["config"]), device="cpu")
    if fit.get("seeded"):
        model.init()
    else:
        init = torch.load(spec["init"], weights_only=True)
        model.lm.load_state_dict(init["lm"])
        model.aligner.load_state_dict(init["aligner"])
    save_config(model, out)
    logger = MetricsLogger(out)
    try:
        _, history = model.fit(
            TMAlignDataset(fit.get("train", spec["train"])),
            TMAlignDataset(fit.get("valid", spec["valid"])),
            logger=logger,
            checkpointer=Checkpointer(os.path.join(out, "checkpoints")),
            mesh="auto")
    finally:
        logger.close()
    save_model(model, out)
    in_mesh = model.mesh is not None and \
        model.mesh.get_coordinate() is not None
    return dict(history=history, step=model.step,
                aligner=model.aligner.state_dict(), lm=model.lm.state_dict(),
                dp=model.mesh.size(0) if in_mesh else None,
                coordinate=list(model.mesh.get_coordinate()) if in_mesh
                else None, logger_path=logger.path)


def run_sharded(spec):
    """This rank's shard of a float64 problem (``make_mesh(dp=world)``):
    ``expected_alignment`` and the gradient of ``(E * E).sum()``."""
    from deepblast_torch.ops import dp as dp_ops
    prob = torch.load(spec["sharded"], weights_only=True)
    mesh = mesh_lib.make_mesh(dp=spec["world"], tp=1, device_type="cpu")
    part = mesh_lib.shard_batch(prob, mesh)
    theta = part["theta"].requires_grad_()
    A = part["A"].requires_grad_()
    E = dp_ops.expected_alignment(theta, A, (part["ln"], part["lm"]))
    g = torch.autograd.grad((E * E).sum(), (theta, A))
    return dict(E=E.detach(), g_theta=g[0], g_A=g[1])


def run_shard_params(spec):
    """Placements and local shapes of a tiny T5's and a CNN aligner's
    parameters under ``shard_params(use_tp=True)`` on a ``(2, 2)`` mesh."""
    from deepblast_torch.models.aligner import NeuralAligner
    from deepblast_torch.models.lm import T5Config, T5Encoder
    mesh = mesh_lib.make_mesh(dp=2, tp=2, device_type="cpu")
    torch.manual_seed(0)
    out = {}
    for tag, module in (("lm", T5Encoder(T5Config(**spec["t5"]))),
                        ("aligner", NeuralAligner(embedding_dim=32,
                                                  hidden_dim=16, layers=2))):
        mesh_lib.shard_params(module, mesh, use_tp=True)
        for name, p in module.named_parameters():
            out[f"{tag}.{name}"] = (tuple(repr(x) for x in p.placements),
                                    tuple(p.to_local().shape),
                                    tuple(p.shape))
    return out


def run_search_torchrun(spec, rank):
    """``cli.search`` as torchrun starts it (its environment, no process
    group; the address is never dialled): the models this rank loaded,
    and whether it joined a group."""
    import torch.distributed as dist
    from deepblast_torch.cli import search
    from deepblast_torch.train import checkpoint
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(spec["world"]), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT="1")
    load, loads = checkpoint.load_model, []

    def counted(*a, **k):
        loads.append(a)
        return load(*a, **k)

    checkpoint.load_model = counted
    try:
        rc = search.main(spec["search_torchrun"] + ["--device", "cpu"])
    finally:
        checkpoint.load_model = load
    return dict(rc=rc, loads=len(loads), joined=dist.is_initialized())


def main(spec_path, rank):
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    mesh_lib.initialize_distributed(
        f"file://{spec['store']}", spec["world"], rank, backend="gloo")
    res = {}
    try:
        for fit in spec.get("fits", []):
            res[fit["name"]] = run_fit(
                spec, fit, os.path.join(spec["dir"], fit["name"]))
        if spec.get("sharded"):
            res["sharded"] = run_sharded(spec)
        if spec.get("shard_params"):
            res["shard_params"] = run_shard_params(spec)
        if spec.get("search"):
            from deepblast_torch.cli import search
            search.main(spec["search"] + ["--device", "cpu"])
    finally:
        torch.distributed.destroy_process_group()
    if spec.get("search_torchrun"):
        res["search_torchrun"] = run_search_torchrun(spec, rank)
    torch.save(res, os.path.join(spec["dir"], f"result_{rank}.pt"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1], int(sys.argv[2])))
