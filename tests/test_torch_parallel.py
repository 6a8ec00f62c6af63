"""The port's data parallel slice on the CPU against the JAX package on 8
virtual devices (``tests/conftest.py``): ``parallel.mesh`` (the rows
``shard_batch`` gives a rank, ``make_mesh``'s refusal, the tensor-parallel
rules of ``param_partition_spec``, ``shard_params``' placements), and
``DeepBLAST.fit`` and ``cli.search`` on worlds of gloo ranks.

The worlds are processes of ``tests/torch_parallel_worker.py`` (one
PyTorch thread each, a ``file://`` store in the test's directory), two of
them, started together by one module fixture while this process runs the
JAX references: 2 ranks (``fit`` at K = 1, ``fit`` at K = 2 with
``grad_accum`` 2, a sharded ``expected_alignment``, ``cli.search --mesh
auto``, then ``--mesh none`` under torchrun's environment without a
group) and 4 ranks (``fit`` with ``tp`` 2, ``fit`` at ``batch_size`` 6
on a mesh of 3, ``shard_params``).  The training set (14 rows) and the
validation set (6) are not multiples of ``batch_size``, so the last
short batch of each is dropped, as under the JAX mesh.

Tolerances: the trajectories (every logged loss and statistic, the
history) rtol 1e-4, as ``tests/test_torch_train.py``'s one-process
trajectories (fp32, two libraries over 6 steps); the final aligner
weights rtol 1e-4 with atol 1e-4 of each tensor's largest magnitude (an
update of AdamW moves a near-zero weight by up to the learning rate);
between ranks, exactly; the sharded float64 ``expected_alignment`` and
its gradient equal the unsharded port's to 1e-12 and JAX's GSPMD-sharded
ones to 1e-9; search scores rtol 1e-4 / atol 1e-5 (the JAX package's own
``tests/test_cli.py::test_search_cli_mesh_parity``).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from deepblast_torch.cli import search as tsearch
from deepblast_torch.data import dataset as tds
from deepblast_torch.models import lm as tlm
from deepblast_torch.models.aligner import NeuralAligner
from deepblast_torch.models.convert import params_from_jax
from deepblast_torch.ops import dp as tdp
from deepblast_torch.parallel import mesh as tmesh
from deepblast_torch.train import trainer as ttrainer
from deepblast_torch.train.checkpoint import load_model, save_model
from deepblast_tpu.cli import search as jsearch
from deepblast_tpu.data import dataset as jds
from deepblast_tpu.models import lm as jlm
from deepblast_tpu.ops import dp as jdp
from deepblast_tpu.parallel import mesh as jmesh
from deepblast_tpu.train import checkpoint as jcheckpoint
from deepblast_tpu.train import trainer as jtrainer
from test_torch_train import TINY, _Rec, _same_trajectory, _write_tsv
from test_train import fixture_frame
import torch_threads  # noqa: F401  (PyTorch threads a worker)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_parallel_worker.py")
TINY_T5 = dict(vocab_size=32, d_model=32, d_kv=8, d_ff=64, num_layers=2,
               num_heads=4)
# the two-rank world's fits and the four-rank world's, over TINY
FITS2 = {"k1": {}, "k2_accum2": dict(steps_per_dispatch=2, grad_accum=2)}
FITS4 = {"tp2": dict(tp=2), "auto6": dict(batch_size=6)}
# and a fit from the port's seeded init, held to one process of the port: a
# finetuned BiLM (its unused next-token head, the LSTMs' frozen second
# biases) and RNN heads under DistributedDataParallel
BILM = dict(lm_type="bilstm", layer_type="rnn", finetune=True)
QUERIES = ["ACDEFGHIKL", "MNPQRSTVWY", "ACDACD", "KLMKLMNPQ"]
DB = ["ACDEFGHIKL", "TVWYACDE", "GHIKLMNP"]


# ---------------------------------------------------------------------------
# in process: parallel.mesh against deepblast_tpu.parallel.mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stacked", [False, True], ids=["batch", "stacked"])
def test_shard_batch_takes_the_jax_shards(stacked):
    """Rank ``(d, t)``'s rows of a plain or a stacked ``(K, B, ...)`` batch
    are the ``addressable_shards`` of the JAX ``shard_batch`` on the
    device at ``(d, t)`` of ``make_mesh(dp=4, tp=2)`` (the model axis
    replicates); lists and arrays without the batch axis pass through."""
    rng = np.random.default_rng(0)
    lead = (3,) if stacked else ()
    batch = dict(x=rng.integers(0, 20, lead + (8, 5)).astype(np.int32),
                 x_len=rng.integers(1, 5, lead + (8,)).astype(np.int32),
                 aln=rng.random(lead + (8, 5, 4)),
                 step=np.int32(7), states=[[1, 2]] * 8)
    mesh = jmesh.make_mesh(dp=4, tp=2)
    jb = jmesh.shard_batch({k: v if isinstance(v, list) else jnp.asarray(v)
                            for k, v in batch.items()}, mesh,
                           stacked=stacked)
    for (d, t), dev in np.ndenumerate(mesh.devices):
        got = tmesh.shard_batch(batch, (4, 2), stacked=stacked,
                                coordinate=(d, t))
        assert got["states"] is batch["states"]
        assert got["step"] is batch["step"]
        for k in ("x", "x_len", "aln"):
            want = [s.data for s in jb[k].addressable_shards
                    if s.device == dev]
            np.testing.assert_array_equal(got[k], np.asarray(want[0]),
                                          err_msg=f"{k} at {(d, t)}")


def test_make_mesh_refuses_as_jax():
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(dp=3, tp=2)
    with pytest.raises(ValueError) as got:
        tmesh.make_mesh(dp=3, tp=2, devices=range(8))
    assert str(got.value) == str(want.value) == "mesh 3x2 != 8 devices"
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        tmesh.make_mesh(dp=2)       # no process group: one rank


def _port_placement(spec, ndim):
    """The port's placements for a flax ``PartitionSpec`` of a leaf of
    ``ndim`` dimensions: flax's (in, out) kernel is torch's (out, in) and
    flax's (k, in, out) convolution torch's (out, in, k), so flax's
    dimension i is torch's ndim - 1 - i."""
    dims = [i for i, ax in enumerate(spec) if ax == "model"]
    if not dims:
        return (Replicate(), Replicate())
    return (Replicate(), Shard(ndim - 1 - dims[0]))


def _flax_leaves(tree):
    """``(path, leaf, port name)`` of every flax leaf: the port name is
    ``params_from_jax``'s of the leaf alone."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        sub = leaf
        for k in reversed(path):
            sub = {k.key: sub}
        (name,) = params_from_jax(sub)
        out.append((path, leaf, name))
    return out


def test_param_partition_spec_is_the_jax_rule(started):
    """On a tiny T5 and a CNN aligner, every parameter's placements are
    the JAX ``param_partition_spec`` of its flax leaf, in torch's layout;
    attention outputs and ``ff.wo`` shard their input dimension, the other
    linear and convolution weights their output dimension."""
    jt5 = jax.jit(jlm.T5Encoder(jlm.T5Config(**TINY_T5)).init)(
        jax.random.key(0), jnp.zeros((1, 4), jnp.int32))
    jal = started["init"].params["aligner"]
    seen = set()
    for tree, module in ((jt5, tlm.T5Encoder(tlm.T5Config(**TINY_T5))),
                         (jal, NeuralAligner(embedding_dim=16, hidden_dim=16,
                                             layers=2, k_size=5))):
        params = dict(module.named_parameters())
        leaves = _flax_leaves(tree)
        assert sorted(n for _, _, n in leaves) == sorted(params)
        for path, leaf, name in leaves:
            owner = module.get_submodule(name.rpartition(".")[0])
            got = tmesh.param_partition_spec(name, params[name], owner)
            want = _port_placement(jmesh.param_partition_spec(path, leaf),
                                   leaf.ndim)
            assert got == want, name
            seen.add(got)
    assert seen == {(Replicate(), Replicate()), (Replicate(), Shard(0)),
                    (Replicate(), Shard(1))}


# ---------------------------------------------------------------------------
# the worlds of gloo ranks
# ---------------------------------------------------------------------------

def _spawn(spec, root):
    """Start ``spec["world"]`` ranks of the worker; returns the processes
    with their log files."""
    path = root / f"spec{spec['world']}.json"
    path.write_text(json.dumps(spec))
    procs = []
    for r in range(spec["world"]):
        log = open(root / f"world{spec['world']}_rank{r}.log", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, str(path), str(r)], stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _join(procs, timeout=240):
    """Wait for every rank; raise with its log if one failed."""
    for p, log in procs:
        rc = p.wait(timeout=timeout)
        log.seek(0)
        text = log.read()
        if rc != 0:
            raise AssertionError(f"a rank exited with {rc}:\n{text[-4000:]}")


def _jax_fit(train, valid, mesh, **fields):
    """The JAX trainer (scan backend) from its seeded init under ``mesh``:
    logged rows, history and the final aligner as a port state dict."""
    model = jtrainer.DeepBLAST(jtrainer.DeepBLASTConfig(
        backend="scan", **dict(TINY, **fields)))
    model.state = model.init()
    rec = _Rec()
    # copies: the JAX dataset renames the frame's columns in place
    state, hist = model.fit(jds.TMAlignDataset(train.copy()),
                            jds.TMAlignDataset(valid.copy()), logger=rec,
                            mesh=mesh)
    return rec.rows, hist, params_from_jax(state.params["aligner"])


def _search_argv(tdir, out, mesh, batch=5):
    return ["--query-fasta", tdir["q"], "--db-fasta", tdir["db"],
            "--load-from-checkpoint", tdir["model"], "--output-file", out,
            "--batch-size", str(batch), "--mesh", mesh]


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The inputs, and both worlds started with the module's first test,
    so that they run beside it; on the way out a rank still running is
    killed."""
    root = tmp_path_factory.mktemp("parallel")
    train, valid = fixture_frame(14, seed=5), fixture_frame(6, seed=6)
    _write_tsv(root / "train.tsv", train)
    _write_tsv(root / "valid.tsv", valid)
    # whole batches of 4 for the fit held to one process of the port
    _write_tsv(root / "train16.tsv", fixture_frame(16, seed=7))
    _write_tsv(root / "valid8.tsv", fixture_frame(8, seed=8))
    config = jtrainer.DeepBLASTConfig(backend="scan", **TINY)
    init = jtrainer.DeepBLAST(config).init()
    weights = {"lm": params_from_jax(init.lm_params),
               "aligner": params_from_jax(init.params["aligner"])}
    torch.save(weights, root / "init.pt")
    # a model directory of each package with these weights, and FASTAs
    search = dict(q=str(root / "q.fa"), db=str(root / "db.fa"),
                  jax=str(root / "jax_model"), model=str(root / "port_model"))
    port = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(**TINY),
                              device="cpu")
    port.lm.load_state_dict(weights["lm"])
    port.aligner.load_state_dict(weights["aligner"])
    save_model(port, search["model"])
    for path, prefix, seqs in ((search["q"], "q", QUERIES),
                               (search["db"], "d", DB)):
        with open(path, "w") as f:
            f.writelines(f">{prefix}{i}\n{s}\n" for i, s in enumerate(seqs))
    # a float64 problem for the sharded expected alignment
    rng = np.random.default_rng(1)
    prob = dict(theta=torch.tensor(rng.standard_normal((4, 12, 10))),
                A=torch.tensor(rng.standard_normal((4, 12, 10)) - 1.0),
                ln=torch.tensor([12, 9, 11, 7]),
                lm=torch.tensor([10, 10, 6, 8]))
    torch.save(prob, root / "sharded.pt")

    common = dict(init=str(root / "init.pt"), train=str(root / "train.tsv"),
                  valid=str(root / "valid.tsv"))
    w2, w4 = root / "w2", root / "w4"
    w2.mkdir()
    w4.mkdir()
    procs = _spawn(dict(
        common, world=2, store=str(root / "store2"), dir=str(w2),
        fits=[dict(name=k, config=dict(TINY, dp_bf16_residuals=False, **v))
              for k, v in FITS2.items()] + [
            dict(name="bilm", seeded=True, train=str(root / "train16.tsv"),
                 valid=str(root / "valid8.tsv"),
                 config=dict(TINY, dp_bf16_residuals=False, **BILM))],
        sharded=str(root / "sharded.pt"),
        search=_search_argv(search, str(w2 / "hits_auto.tsv"), "auto"),
        search_torchrun=_search_argv(search, str(w2 / "hits_torchrun.tsv"),
                                     "none")),
        root)
    procs += _spawn(dict(
        common, world=4, store=str(root / "store4"), dir=str(w4),
        fits=[dict(name=k, config=dict(TINY, dp_bf16_residuals=False, **v))
              for k, v in FITS4.items()],
        shard_params=True, t5=TINY_T5), root)
    try:
        yield dict(root=root, train=train, valid=valid, search=search,
                   prob=prob, procs=procs, init=init, config=config)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()


@pytest.fixture(scope="module")
def worlds(started):
    """Both worlds' results and the JAX references they are held to."""
    root, train, valid, search = (started[k] for k in
                                  ("root", "train", "valid", "search"))
    w2, w4 = root / "w2", root / "w4"
    try:
        # orbax's save takes seconds: here, beside the worlds
        jcheckpoint.save_config(started["config"], search["jax"])
        jcheckpoint.Checkpointer(os.path.join(search["jax"], "checkpoints")) \
            .save(started["init"], {"validation_loss": 1.0})
        jax_runs = {
            "k1": _jax_fit(train, valid, jmesh.make_mesh(
                dp=2, tp=1, devices=jax.devices()[:2])),
            "k2_accum2": _jax_fit(train, valid, jmesh.make_mesh(
                dp=2, tp=1, devices=jax.devices()[:2]), **FITS2["k2_accum2"]),
            "tp2": _jax_fit(train, valid, jmesh.make_mesh(
                dp=2, tp=2, devices=jax.devices()[:4]), tp=2),
        }
        hits = {}
        for name, main, mesh in (("jax_auto", jsearch.main, "auto"),
                                 ("none", tsearch.main, "none")):
            hits[name] = root / f"hits_{name}.tsv"
            argv = _search_argv(search, str(hits[name]), mesh)
            if name == "jax_auto":
                argv[argv.index(search["model"])] = search["jax"]
            else:
                argv += ["--device", "cpu"]
            assert main(argv) == 0
        hits["auto"] = w2 / "hits_auto.tsv"
    finally:
        _join(started["procs"])
    results = {}
    for w, n in ((w2, 2), (w4, 4)):
        results[n] = [torch.load(w / f"result_{r}.pt", weights_only=False)
                      for r in range(n)]
    return dict(started, jax=jax_runs, results=results, hits=hits)


def _metrics(out):
    """``(tag, step, value)`` of the one ``metrics.jsonl`` in ``out``."""
    logs = [d for d in os.listdir(out) if d.startswith("logdir_")]
    assert len(logs) == 1, logs
    with open(os.path.join(out, logs[0], "metrics.jsonl")) as f:
        return [(r["tag"], r["step"], r["value"])
                for r in map(json.loads, f)]


def _same_weights(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        scale = v.abs().max().item()
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)


def _ranks_agree(runs):
    """Every rank's history and final weights are rank 0's, exactly."""
    for run in runs[1:]:
        assert run["history"] == runs[0]["history"]
        assert run["step"] == runs[0]["step"]
        for k, v in runs[0]["aligner"].items():
            assert torch.equal(run["aligner"][k], v), k


@pytest.mark.parametrize("name", list(FITS2))
def test_two_rank_fit_matches_jax_mesh(worlds, name):
    """2 gloo ranks, ``fit(mesh="auto")`` (dp 2): the trajectory (rank 0's
    ``metrics.jsonl``: 6 steps, the 4th short batch of each epoch and the
    validation set's last 2 rows dropped) and history equal the JAX fit
    under ``make_mesh(dp=2, tp=1)``; the final aligner too; both ranks end
    equal.  K = 1, and K = 2 with ``grad_accum`` 2."""
    runs = [res[name] for res in worlds["results"][2]]
    _ranks_agree(runs)
    assert [r["dp"] for r in runs] == [2, 2]
    assert [r["coordinate"] for r in runs] == [[0, 0], [1, 0]]
    jrows, jhist, jal = worlds["jax"][name]
    rows = _metrics(worlds["root"] / "w2" / name)
    _same_trajectory((rows, runs[0]["history"]), (jrows, jhist), rtol=1e-4)
    _same_weights(runs[0]["aligner"], jal)


def test_two_rank_fit_of_a_finetuned_bilm_matches_one_process(worlds):
    """The trouble spots of DDP, 2 ranks against one process of the port
    from the same seeded init on whole batches (16 and 8 rows): a
    finetuned BiLM (its next-token head gets no gradient, its LSTMs'
    second biases are frozen) under RNN heads; the history, the final
    aligner and LM at rtol 1e-4 (the weights with atol 1e-4 of each
    tensor's scale); the head still zero, the biases still frozen."""
    runs = [res["bilm"] for res in worlds["results"][2]]
    _ranks_agree(runs)
    model = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(
        **dict(TINY, dp_bf16_residuals=False, **BILM)), device="cpu").init()
    head = model.lm.linear.weight.detach().clone()
    root = worlds["root"]
    _, hist = model.fit(tds.TMAlignDataset(str(root / "train16.tsv")),
                        tds.TMAlignDataset(str(root / "valid8.tsv")))
    assert [h.keys() for h in runs[0]["history"]] == [h.keys() for h in hist]
    for got, want in zip(runs[0]["history"], hist):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    _same_weights(runs[0]["aligner"], model.aligner.state_dict())
    _same_weights(runs[0]["lm"], model.lm.state_dict())
    assert torch.equal(runs[0]["lm"]["linear.weight"], head)
    for k, v in runs[0]["lm"].items():
        if k.endswith("bias_ih_l0"):
            assert not v.any(), k


def test_rank_zero_alone_writes(worlds):
    """The output directory of a 2-rank ``fit`` holds one writer's files:
    one log directory whose records appear once, the config, the final
    weights (``model.pt``, the unwrapped modules' state dicts, which
    ``load_model`` serves) and the best checkpoints; rank 1's logger
    opened nothing."""
    for name in FITS2:
        out = worlds["root"] / "w2" / name
        names = sorted(os.listdir(out))
        assert names[:2] == ["checkpoints", "config.json"]
        assert names[2].startswith("logdir_") and names[3:] == ["model.pt"]
        rows = _metrics(out)
        assert len(rows) == len(set(rows))
        assert sum(t == "train_loss" for t, _, _ in rows) == 6
        assert 1 <= len(os.listdir(out / "checkpoints")) <= 3
        runs = [res[name] for res in worlds["results"][2]]
        assert runs[0]["logger_path"] is not None
        assert runs[1]["logger_path"] is None
        saved = torch.load(out / "model.pt", weights_only=True)["aligner"]
        assert saved.keys() == runs[0]["aligner"].keys()
        for k, v in saved.items():
            assert torch.equal(v, runs[0]["aligner"][k]), k
        model = load_model(str(out), device="cpu")
        assert str(model.step) in os.listdir(out / "checkpoints")


def test_four_rank_fit_with_tp2_matches_jax(worlds):
    """4 gloo ranks, ``tp`` 2, ``mesh="auto"``: dp 2 x tp 2, the ranks of
    one data coordinate replicate; equal to the JAX fit on a dp 2 x tp 2
    mesh."""
    runs = [res["tp2"] for res in worlds["results"][4]]
    _ranks_agree(runs)
    assert [r["coordinate"] for r in runs] == [[0, 0], [0, 1], [1, 0],
                                               [1, 1]]
    jrows, jhist, jal = worlds["jax"]["tp2"]
    rows = _metrics(worlds["root"] / "w4" / "tp2")
    _same_trajectory((rows, runs[0]["history"]), (jrows, jhist), rtol=1e-4)
    _same_weights(runs[0]["aligner"], jal)


def test_auto_mesh_leaves_spare_ranks_out(worlds):
    """``batch_size`` 6 on 4 ranks: ``mesh="auto"`` trains on 3 (the
    largest divisor of 6 that fits), the 4th takes no batch and ends with
    rank 0's history, step and weights."""
    runs = [res["auto6"] for res in worlds["results"][4]]
    assert [r["dp"] for r in runs] == [3, 3, 3, None]
    assert runs[3]["coordinate"] is None
    _ranks_agree(runs)
    assert runs[0]["step"] == 4       # 14 rows: 2 batches of 6 an epoch
    assert [h["epoch"] for h in runs[3]["history"]] == [0, 1]


def test_shard_params_places_by_the_rule(worlds):
    """``shard_params(use_tp=True)`` on a ``(2, 2)`` mesh places each
    parameter of a tiny T5 and a CNN aligner by ``param_partition_spec``:
    a sharded one keeps half of its dimension on each model rank."""
    got = worlds["results"][4][0]["shard_params"]
    assert worlds["results"][4][3]["shard_params"] == got
    mods = {"lm": tlm.T5Encoder(tlm.T5Config(**TINY_T5)),
            "aligner": NeuralAligner(embedding_dim=32, hidden_dim=16,
                                     layers=2)}
    want = {}
    for tag, module in mods.items():
        for name, p in module.named_parameters():
            owner = module.get_submodule(name.rpartition(".")[0])
            spec = tmesh.param_partition_spec(name, p, owner)
            local = list(p.shape)
            for s in spec:
                if isinstance(s, Shard):
                    local[s.dim] //= 2
            want[f"{tag}.{name}"] = (tuple(repr(s) for s in spec),
                                     tuple(local), tuple(p.shape))
    assert got == want
    assert any("Shard(dim=1)" in s[0][1] for s in got.values())


def test_sharded_expected_alignment_equals_unsharded(worlds):
    """Each of 2 ranks' ``expected_alignment`` of its rows, and the
    gradient of ``(E * E).sum()``, concatenated: the unsharded port's, and
    JAX's under a data-sharded ``jit`` (``tests/test_mesh_pallas.py``)."""
    shards = [res["sharded"] for res in worlds["results"][2]]
    prob = worlds["prob"]
    theta = prob["theta"].clone().requires_grad_()
    A = prob["A"].clone().requires_grad_()
    E = tdp.expected_alignment(theta, A, (prob["ln"], prob["lm"]))
    g = torch.autograd.grad((E * E).sum(), (theta, A))
    mesh = jmesh.make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    sh = NamedSharding(mesh, P("data"))
    args = [jax.device_put(jnp.asarray(prob[k].numpy()), sh)
            for k in ("theta", "A", "ln", "lm")]

    def loss(t, a, n, m):
        E = jdp.expected_alignment(t, a, (n, m), backend="scan")
        return jnp.sum(E ** 2), E

    (_, jE), jg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True))(*args)
    for key, whole, jwhole in (("E", E.detach(), jE),
                               ("g_theta", g[0], jg[0]),
                               ("g_A", g[1], jg[1])):
        got = torch.cat([s[key] for s in shards])
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                                   atol=1e-12, err_msg=key)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwhole), rtol=0,
                                   atol=1e-9, err_msg=key)


def _lines(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def test_search_mesh_auto_matches_none_and_jax(worlds):
    """``cli.search --mesh auto`` on 2 ranks (launches of 6 rows, the last
    item repeated) = ``--mesh none`` (launches of 5) = the JAX package's
    ``--mesh auto`` on 8 devices, line for line, scores to rtol 1e-4."""
    auto, none, jax_ = (_lines(worlds["hits"][k])
                        for k in ("auto", "none", "jax_auto"))
    assert len(auto) == len(QUERIES) * len(DB)
    for a, n, j in zip(auto, none, jax_):
        assert a[:2] == n[:2] == j[:2]
        for i in (2, 3):
            np.testing.assert_allclose(float(a[i]), float(n[i]), rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(float(a[i]), float(j[i]), rtol=1e-4,
                                       atol=1e-5)


def test_search_queue_writes_the_synchronous_file(worlds):
    """The in-flight queue's file (``--mesh none``: launches of 5, two in
    flight) is byte for byte the file of a synchronous loop over the same
    launches, each scored and written before the next."""
    from deepblast_torch.data.dataset import FastaDataset
    from deepblast_torch.data.state_utils import pad_sequences
    s = worlds["search"]
    model = load_model(s["model"], device="cpu")
    items = list(FastaDataset(s["q"], s["db"], tokenizer=model.tokenizer))

    def padded(seqs):
        toks, lens = pad_sequences(seqs)
        L = -(-toks.shape[1] // 64) * 64
        return np.pad(toks, ((0, 0), (0, L - toks.shape[1]))), lens

    lines = []
    for i in range(0, len(items), 5):
        its = items[i:i + 5]
        its = its + [its[-1]] * (5 - len(its))
        xs, xl = padded([it["x"] for it in its])
        ys, yl = padded([it["y"] for it in its])
        scores = model.score_pairs(dict(x=xs, y=ys, x_len=xl, y_len=yl))
        for it, sc, ql, dl in zip(items[i:i + 5], scores.numpy(), xl, yl):
            norm = sc / (float(ql) * float(dl))
            lines.append(f"{it['qid']}\t{it['dbid']}\t{np.round(sc, 4)}\t"
                         f"{np.round(norm, 4)}\n")
    assert worlds["hits"]["none"].read_text() == "".join(lines)


def test_search_mesh_none_under_torchrun_scores_on_rank_zero(worlds):
    """``cli.search --mesh none`` started as torchrun starts it (``RANK``
    and the rest, no process group): it joins no group, the process of
    ``RANK`` 0 alone loads the model, scores and writes, the other
    returns at once, and the file is ``--mesh none``'s in one process."""
    runs = [res["search_torchrun"] for res in worlds["results"][2]]
    assert [r["rc"] for r in runs] == [0, 0]
    assert [r["loads"] for r in runs] == [1, 0]
    assert not any(r["joined"] for r in runs)
    assert (worlds["root"] / "w2" / "hits_torchrun.tsv").read_text() == \
        worlds["hits"]["none"].read_text()
