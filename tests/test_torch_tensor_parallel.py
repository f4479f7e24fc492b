"""The port's 2-D mesh and tensor parallelism
(deep_kernel_transfer_tpu_torch/parallel), and the comparison methods on
its episode-parallel path, against one process and the JAX package's
sharded steps, with real processes: gloo ranks on the CPU, started by
parallel.spawn_ranks, torch held to one thread (OMP_NUM_THREADS=1).

  (a) tensor_sharding_rules picks the parameters that the JAX rule picks
      on the same model (the JAX flags carried to the port's names by
      utils.convert): DKT on ConvNetS(depth=2) and on Conv4, and the
      ResNet10 trunk, at min_size 1 << 10 and the default, tp 2 and 4;
  (b) four ranks, dp=2 x tp=2, one tensor-parallel DKT step (ConvNetS
      depth 2, f32 trunk, 3-way 2-shot 3-query, 16 px, B = 8): loss,
      gradients and weights bit-equal to the 1-D dp=2 step on two ranks;
      the loss within 1e-4 relative of the JAX
      make_sharded_train_step(param_shardings=...) on make_mesh_2d(2, 2)
      of the virtual CPU devices (the JAX test's own tolerance,
      tests/test_parallel.py:133); each rank's sharded parameters and
      Adam moments 1/tp of the full ones; and on the same four ranks the
      zoo's tensor-parallel steps (protonet, matchingnet with its six
      LSTM weights as tp chunks, relationnet, second-order maml and
      maml_approx, min_size 1 << 10) bit-equal to their 1-D dp=2 steps;
  (c) the 2-D mesh's episode functions: the tp ranks of one dp group get
      the same rows and the dp groups together the one-process batch
      (shard_episode_batch, make_sharded_eval, DeviceDataset.shard);
      wrap_pad_episodes pads to the dp extent;
  (d) refusals: a world that is not dp*tp, a missing tp group, a chunk of
      the wrong shape;
  and the zoo: protonet, matchingnet, relationnet, maml and maml_approx
  (n_task = B = 4, two episodes a rank) and BaselineTrain's batch-sharded
  step on two ranks, against one process and (the five) the JAX sharded
  gradient on the same weights, with tests/test_torch_methods_zoo.py's
  converters and tolerances: losses 1e-5 of the larger of 1 and the
  value, gradients 2e-2 of each tensor's largest entry (a conv bias
  before a train-mode BatchNorm, whose exact gradient is 0, below 1e-3 of
  the conv weight's), accuracies 1e-4.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

from deep_kernel_transfer_tpu import parallel as jpar
from deep_kernel_transfer_tpu.methods import DKT as JDKT
from deep_kernel_transfer_tpu.methods import BaselineTrain as JBaseline
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu_torch.data.device_dataset import DeviceDataset
from deep_kernel_transfer_tpu_torch.methods import DKT, BaselineTrain
from deep_kernel_transfer_tpu_torch.models import ConvNet
from deep_kernel_transfer_tpu_torch.models import backbones as tbb
from deep_kernel_transfer_tpu_torch.parallel import (
    MODEL_AXIS, Mesh, gather_state, make_mesh, make_mesh_2d,
    make_sharded_eval, make_sharded_train_step, replicate_tree,
    shard_episode_batch, spawn_ranks, tensor_sharding_rules,
    wrap_pad_episodes)
from deep_kernel_transfer_tpu_torch.parallel.mesh import (
    TensorParallelChunk, shard_parameters, tp_chunks)
from deep_kernel_transfer_tpu_torch.utils.checkpoint import save_checkpoint
from deep_kernel_transfer_tpu_torch.utils.convert import (
    backbone_state_from_jax, dkt_params_from_jax, state_from_jax)
from test_torch_methods_zoo import (PX as ZOO_PX, QUERY as ZOO_QUERY,
                                    SHOT as ZOO_SHOT, WAY as ZOO_WAY,
                                    _check_grads, _close, _episodic_pair,
                                    _jax_params, _load, _randomise_bn)
from torch_test_threads import one_thread  # noqa: F401

B, WAY, SHOT, QUERY, PX = 8, 3, 2, 3, 16
ZOO_B = 4  # two episodes a rank; MAML's n_task
ZOO = ("protonet", "matchingnet", "relationnet", "maml", "maml_approx")
LSTM_WEIGHTS = ("G_encoder.weight_ih_l0", "G_encoder.weight_hh_l0",
                "G_encoder.weight_ih_l0_reverse",
                "G_encoder.weight_hh_l0_reverse", "FCE.lstmcell.weight_ih",
                "FCE.lstmcell.weight_hh")
CPU = torch.device("cpu")


def _dkt():
    return DKT(ConvNet(2, first_channel=True), WAY, SHOT, "bncossim",
               feature_dtype="float32", device="cpu")


def _episodes(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _full_grads(model, mesh) -> dict:
    """Every parameter's gradient, a tp chunk's all-gathered over the tp
    group."""
    out, chunks = {}, tp_chunks(model)
    for name, p in model.named_parameters():
        g = p.grad
        if name in chunks:
            g = chunks[name].gather(g)
        out[name] = g.clone()
    return out


def _chunk_bytes(model) -> dict:
    """Each tp-sharded parameter's bytes on this rank, with Adam's two
    moments of it."""
    params = dict(model.named_parameters())
    return {n: sum(t.numel() * t.element_size() for t in (
        params[n], model.optimizer.state[params[n]]["exp_avg"],
        model.optimizer.state[params[n]]["exp_avg_sq"]))
        for n in tp_chunks(model)}


def _gathered(obj, mesh):
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


# -- the ranks -----------------------------------------------------------------

def _dp_ranks(x, state, zoo, base, ckpt):
    """On each of 2 ranks of a 1-D mesh: the DKT sharded step from `state`
    (its checkpoint saved by rank 0 to `ckpt`); each zoo family's sharded
    step and sharded eval; BaselineTrain's batch-sharded step. Returns (on
    rank 0) their losses, gradients, states and accuracies."""
    mesh = make_mesh(2, "cpu")
    model = _dkt().init(torch.from_numpy(x[0]))  # each rank draws its own
    if mesh.rank == 0:
        model.load_state_dict(state)
    replicate_tree([model, model.optimizer], mesh)
    m = make_sharded_train_step(model, mesh)(shard_episode_batch(x, mesh))
    out = {"dkt": {"loss": float(m["loss"]), "grads": _full_grads(model, mesh),
                   "state": gather_state(model)}}
    if mesh.rank == 0:
        save_checkpoint(ckpt, model, 1)
    for name, (params, xb) in zoo.items():
        _, tm, px = _episodic_pair(name)
        tm = _load(tm, params, px, xb[0])
        m = make_sharded_train_step(tm, mesh)(shard_episode_batch(xb, mesh))
        out[name] = {"loss": float(m["loss"]),
                     "grads": {n: p.grad.clone()
                               for n, p in tm.named_parameters()},
                     "state": tm.state_dict(),
                     "accs": make_sharded_eval(tm, mesh)(
                         shard_episode_batch(xb, mesh))}
    xs, ys, bstate = base
    bm = BaselineTrain(tbb.ConvNet(2), 4, device="cpu").init(
        torch.from_numpy(xs))
    bm.load_state_dict(bstate)
    m = make_sharded_train_step(bm, mesh)(shard_episode_batch(xs, mesh),
                                          shard_episode_batch(ys, mesh))
    out["baseline"] = {"loss": float(m["loss"]),
                       "grads": {n: p.grad.clone()
                                 for n, p in bm.named_parameters()},
                       "state": bm.state_dict()}
    return out


def _tp_ranks(x, state, zoo, data_file, ckpt):
    """On each of 4 ranks of a dp=2 x tp=2 mesh: one tensor-parallel DKT
    step from `state`; the sharded parameters' local and full bytes; the
    gathered state, its largest difference between the ranks and rank 0's
    checkpoint; the mesh's episode functions; each zoo family's
    tensor-parallel step (min_size 1 << 10) with its sharded names and
    bytes. Returns (on rank 0) what each rank saw."""
    mesh = make_mesh_2d(2, 2, "cpu")
    model = _dkt().init(torch.from_numpy(x[0]))
    if mesh.rank == 0:
        model.load_state_dict(state)
    replicate_tree([model, model.optimizer], mesh)
    rules = tensor_sharding_rules(model, mesh, min_size=1 << 10)
    full = {n: p.numel() * p.element_size()
            for n, p in model.named_parameters() if rules[n] is not None}
    step = make_sharded_train_step(model, mesh, param_shardings=rules)
    m = step(shard_episode_batch(x, mesh))
    chunks = {n: p.detach().clone() for n, p in model.named_parameters()
              if n in tp_chunks(model)}
    local = _chunk_bytes(model)
    st = gather_state(model)
    flat = torch.cat([v.reshape(-1).float() for v in st.values()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    spread = (flat - ref).abs().max().reshape(1)
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    if mesh.rank == 0:
        save_checkpoint(ckpt, model, 1, state=st)
    ds = DeviceDataset(data_file, 16, canvas=True, device="cpu").shard(mesh)
    draws = {batch: next(ds.epoch(5, 2, 1, 2, batch, batch,
                                  augment_to=16)).numpy()
             for batch in (4, 3)}
    seen = {"rank": mesh.rank, "coords": (mesh.dp_rank, mesh.tp_rank),
            "shape": mesh.shape, "loss": float(m["loss"]),
            "grads": _full_grads(model, mesh),
            "chunks": chunks, "local": local, "full": full,
            "rows": shard_episode_batch(np.arange(B), mesh).numpy(),
            "accs": make_sharded_eval(model, mesh)(
                shard_episode_batch(x, mesh)),
            "padded": wrap_pad_episodes(x[:3], mesh)[0].shape[0],
            "draws": draws, "zoo": {}}
    for name, (params, xb) in zoo.items():
        _, tm, px = _episodic_pair(name)
        tm = _load(tm, params, px, xb[0])
        rules = tensor_sharding_rules(tm, mesh, min_size=1 << 10)
        full_bytes = {n: 3 * p.numel() * p.element_size()
                      for n, p in tm.named_parameters()
                      if rules[n] is not None}
        m = make_sharded_train_step(tm, mesh, param_shardings=rules)(
            shard_episode_batch(xb, mesh))
        seen["zoo"][name] = {
            "loss": float(m["loss"]), "grads": _full_grads(tm, mesh),
            "state": gather_state(tm), "sharded": sorted(tp_chunks(tm)),
            "local": _chunk_bytes(tm), "full": full_bytes}
    everyone = _gathered(seen, mesh)
    if mesh.rank == 0:
        return {"ranks": everyone, "state": st, "spread": float(spread)}
    return None


# -- fixtures ------------------------------------------------------------------

def _image_set(root) -> str:
    rng = np.random.RandomState(3)
    names, labels = [], []
    for cl in range(4):
        for i in range(6):
            p = str(root / f"c{cl}_{i}.png")
            Image.fromarray((rng.rand(20, 20, 3) * 255).astype(
                np.uint8)).save(p)
            names.append(p)
            labels.append(cl)
    jf = str(root / "base.json")
    with open(jf, "w") as f:
        json.dump({"label_names": [f"c{i}" for i in range(4)],
                   "image_names": names, "image_labels": labels}, f)
    return jf


def _zoo_inputs() -> dict:
    out = {}
    for name in ZOO:
        jm, _, px = _episodic_pair(name)
        xb = _episodes((ZOO_B, ZOO_WAY, ZOO_SHOT + ZOO_QUERY, px, px, 3),
                       seed=11)
        out[name] = (_jax_params(jm, jnp.asarray(xb[0])), xb)
    return out


def _baseline_inputs():
    xs = _episodes((8, ZOO_PX, ZOO_PX, 3), seed=4)
    ys = np.array([0, 3, 1, 3, 2, 0, 1, 2])
    jm = JBaseline(jbb.ConvNet(depth=2), 4)
    params = _randomise_bn(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(2), jnp.asarray(xs)).params),
        np.random.RandomState(5))
    bm = BaselineTrain(tbb.ConvNet(2), 4, device="cpu").init(
        torch.from_numpy(xs))
    bm.load_state_dict({k: torch.tensor(v) for k, v in state_from_jax(
        params, bm, ZOO_PX).items()})
    return xs, ys, {k: v.clone() for k, v in bm.state_dict().items()}


@pytest.fixture(scope="module")
def runs(one_thread, tmp_path_factory):
    """The JAX init carried to the port; the JAX tensor-parallel loss; the
    two-rank and the four-rank runs."""
    root = tmp_path_factory.mktemp("tensor_parallel")
    x = _episodes((B, WAY, SHOT + QUERY, PX, PX, 3))
    jm = JDKT(jbb.ConvNetS(depth=2), WAY, SHOT, "bncossim",
              feature_dtype="float32")
    jstate = jm.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))
    mesh2 = jpar.make_mesh_2d(2, 2)
    rules = jpar.tensor_sharding_rules(jstate.params, mesh2,
                                       min_size=1 << 10)
    _, jm_metrics = jpar.make_sharded_train_step(
        jm, mesh2, param_shardings=rules)(
            jstate, jpar.shard_episode_batch(jnp.asarray(x), mesh2))
    one = _dkt().init(torch.from_numpy(x[0]))
    dkt_params_from_jax(jax.tree.map(np.asarray, jstate.params), one, PX)
    state = {k: v.clone() for k, v in one.state_dict().items()}
    data_file = _image_set(root)
    ds = DeviceDataset(data_file, 16, canvas=True, device="cpu")  # stages
    full = {batch: next(ds.epoch(5, 2, 1, 2, batch, batch,
                                 augment_to=16)).numpy() for batch in (4, 3)}
    zoo, base = _zoo_inputs(), _baseline_inputs()
    return dict(
        x=x, state=state, jtp_loss=float(jm_metrics["loss"]),
        full_draws=full, zoo=zoo, base=base, root=root,
        dp=spawn_ranks(2, "cpu", _dp_ranks, x, state, zoo, base,
                       str(root / "dp.tar")),
        tp=spawn_ranks(4, "cpu", _tp_ranks, x, state, zoo, data_file,
                       str(root / "tp.tar")))


# -- (a) the sharded set ---------------------------------------------------------

def _jax_flags(params, rules):
    """The JAX params tree with each leaf replaced by 1.0 where the rule
    shards it, else 0.0, in the leaf's shape."""
    return jax.tree.map(
        lambda leaf, s: np.full(leaf.shape, float(s.spec != PartitionSpec()),
                                np.float32), params, rules)


def _rule_sets(name, min_size, tp):
    """(port rules, the port's sharded set, the JAX rule's set carried to
    the port's names, the carried flags) on one model."""
    if name == "resnet10":
        px = 32
        shapes = jax.eval_shape(lambda: jbb.ResNet10().init(
            jax.random.PRNGKey(0), jnp.zeros((1, px, px, 3))))["params"]
        model = tbb.ResNet10()

        def to_port(flags):
            return backbone_state_from_jax({"params": flags}, model, "")
    else:
        if name == "matchingnet":
            jm, model, px = _episodic_pair(name)
        else:
            jtrunk, ttrunk, px = ((jbb.ConvNetS(depth=2),
                                   ConvNet(2, first_channel=True), 16)
                                  if name == "dkt_convnets" else
                                  (jbb.Conv4(), tbb.Conv4(), 32))
            jm = JDKT(jtrunk, WAY, SHOT, "bncossim", feature_dtype="float32")
            model = DKT(ttrunk, WAY, SHOT, "bncossim",
                        feature_dtype="float32", device="cpu")
        example = np.zeros((WAY, SHOT + QUERY, px, px, 3), np.uint8)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.asarray(example))).params
        model.init(torch.from_numpy(example))

        def to_port(flags):
            return state_from_jax(flags, model, px)
    jrules = jpar.tensor_sharding_rules(shapes, jpar.make_mesh_2d(2, tp),
                                        min_size=min_size)
    flags = to_port(_jax_flags(shapes, jrules))
    rules = tensor_sharding_rules(
        model, Mesh(0, 2 * tp, CPU, tp, tp_group=object()),
        min_size=min_size)
    assert set(rules) == {n for n, _ in model.named_parameters()}
    got = {n for n, r in rules.items() if r is not None}
    want = {n for n in rules if flags[n.replace("bias_hh", "bias_ih")].any()}
    return rules, got, want, flags


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("min_size", [1 << 10, 1 << 16])
@pytest.mark.parametrize("name", ["dkt_convnets", "dkt_conv4", "resnet10",
                                  "matchingnet"])
def test_sharded_set_is_the_jax_rules(name, min_size, tp):
    rules, got, want, flags = _rule_sets(name, min_size, tp)
    assert got == want
    assert all(flags[n].all() for n in want)  # every stacked JAX leaf
    assert all(rules[n] == (MODEL_AXIS, 0) for n in got)
    if min_size == 1 << 10:
        assert got  # at least one leaf sharded
    if name == "dkt_convnets" and min_size == 1 << 16:
        assert not got  # 64 * 64 * 9 = 36,864 < 65,536


def test_lstm_rule_counts_one_gate():
    """MatchingNet's LSTMs stack four JAX leaves of [in, H] in each
    weight: one gate's size decides, as in JAX. At min_size H^2 + 1 the
    [H, H] gates of weight_hh stay replicated and the [2H, H] gates of the
    FCE cell's weight_ih shard."""
    h = 576  # the flat features of ConvNet(2) at 12 px
    rules, got, want, _ = _rule_sets("matchingnet", h * h + 1, 2)
    assert got == want
    assert rules["G_encoder.weight_hh_l0"] is None
    assert rules["FCE.lstmcell.weight_hh"] is None
    assert rules["FCE.lstmcell.weight_ih"] == (MODEL_AXIS, 0)
    assert rules["G_encoder.bias_ih_l0"] is None


# -- (b) one tensor-parallel step ------------------------------------------------

def test_tp_step_bit_equal_to_the_1d_step(runs):
    """Only the storage differs: the loss, every gradient (a chunk's
    gathered) and every weight after the step equal the 1-D dp=2 run's
    bit for bit, on each of the four ranks."""
    dp = runs["dp"]["dkt"]
    for seen in runs["tp"]["ranks"]:
        assert seen["loss"] == dp["loss"]
        assert set(seen["grads"]) == set(dp["grads"])
        for name, want in dp["grads"].items():
            assert torch.equal(seen["grads"][name], want), name
    st = runs["tp"]["state"]
    assert set(st) == set(dp["state"])
    for name, want in dp["state"].items():
        assert torch.equal(st[name], want), name
    assert runs["tp"]["spread"] == 0.0  # the gathered weights on all ranks


def test_tp_checkpoint_is_the_replicated_one(runs):
    """save_checkpoint(state=gather_state(...)) of the TP run writes the
    1-D run's reference-layout checkpoint."""
    dp = torch.load(runs["root"] / "dp.tar", weights_only=True)
    tp = torch.load(runs["root"] / "tp.tar", weights_only=True)
    assert dp["epoch"] == tp["epoch"] == 1
    assert set(dp["state"]) == set(tp["state"])
    for name, want in dp["state"].items():
        assert torch.equal(tp["state"][name], want), name


def test_tp_loss_matches_jax_tp_step(runs):
    for seen in runs["tp"]["ranks"]:
        np.testing.assert_allclose(seen["loss"], runs["jtp_loss"], rtol=1e-4)


def test_tp_storage_is_a_tp_chunk(runs):
    """Each rank's sharded parameters and their Adam moments take 1/tp of
    the full bytes (three tensors of a full parameter's size replicated),
    and the two tp ranks of a dp group hold the two halves."""
    ranks = runs["tp"]["ranks"]
    for seen in ranks:
        assert seen["local"] and set(seen["local"]) == set(seen["full"])
        for name, full in seen["full"].items():
            assert seen["local"][name] * 2 == 3 * full, name
    for a, b in ((0, 1), (2, 3)):
        for name, chunk in ranks[a]["chunks"].items():
            other = ranks[b]["chunks"][name]
            assert chunk.shape == other.shape and not torch.equal(chunk,
                                                                  other)
            assert torch.equal(torch.cat([chunk, other]),
                               runs["tp"]["state"][name])
    for a, b in ((0, 2), (1, 3)):  # one tp coordinate: the same chunk
        for name, chunk in ranks[a]["chunks"].items():
            assert torch.equal(chunk, ranks[b]["chunks"][name])


@pytest.mark.parametrize("name", ZOO)
def test_tp_zoo_step_bit_equal_to_the_1d_step(runs, name):
    """Each comparator's tensor-parallel step (dp=2 x tp=2, min_size
    1 << 10: the trunk's convs, MatchingNet's six LSTM weights) against
    its 1-D dp=2 step on the same episodes: the loss, every gradient (a
    chunk's gathered) and every weight after the step bit for bit, on
    each of the four ranks. Second-order MAML differentiates through its
    inner gradient, so a step that cut the weights' gradient to a rank's
    slice inside autograd would get its outer gradient wrong."""
    dp = runs["dp"][name]
    for seen in runs["tp"]["ranks"]:
        got = seen["zoo"][name]
        assert got["sharded"], name  # at least one weight is a tp chunk
        assert got["loss"] == dp["loss"]
        assert set(got["grads"]) == set(dp["grads"])
        for n, want in dp["grads"].items():
            assert torch.equal(got["grads"][n], want), n
        assert set(got["state"]) == set(dp["state"])
        for n, want in dp["state"].items():
            assert torch.equal(got["state"][n], want), n


def test_tp_matchingnet_lstm_weights_are_tp_chunks(runs):
    """MatchingNet's six LSTM weights (the G encoder's four, the FCE
    cell's two) are stored as tp chunks, as the JAX rule shards them:
    with Adam's moments, 1/tp of their replicated bytes on each rank."""
    for seen in runs["tp"]["ranks"]:
        got = seen["zoo"]["matchingnet"]
        assert set(LSTM_WEIGHTS) <= set(got["sharded"])
        assert set(got["local"]) == set(got["full"]) == set(got["sharded"])
        for n in LSTM_WEIGHTS:
            assert got["local"][n] * 2 == got["full"][n], n


# -- (c) the 2-D mesh's episode functions ----------------------------------------

def test_2d_mesh_layout_and_rows(runs):
    """Rank r at (r // 2, r % 2); the tp ranks of a dp group take the same
    rows, the dp groups together the whole batch."""
    for seen in runs["tp"]["ranks"]:
        r = seen["rank"]
        assert seen["coords"] == (r // 2, r % 2)
        assert seen["shape"] == {"dp": 2, "tp": 2}
        np.testing.assert_array_equal(seen["rows"],
                                      np.arange(4) + 4 * (r // 2))
        assert seen["padded"] == 4  # 3 episodes on dp=2: 4, not 8


def test_2d_sharded_eval_is_the_one_process_eval(runs):
    model = _dkt().init(torch.from_numpy(runs["x"][0]))
    model.load_state_dict(runs["tp"]["state"])
    want = model.batch_correct(torch.from_numpy(runs["x"])).numpy()
    for seen in runs["tp"]["ranks"]:
        got = seen["accs"].numpy()
        assert got.shape == (B,)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_2d_dataset_rows_are_the_dp_groups(runs):
    """DeviceDataset.shard on dp=2 x tp=2: the tp ranks of a group draw
    the same episodes and augmentation, the rows of their dp coordinate
    of the one-process batch (3 padded to 4 by wrapping)."""
    for batch, want in runs["full_draws"].items():
        rows = np.arange(4) % batch
        for seen in runs["tp"]["ranks"]:
            d = seen["coords"][0]
            np.testing.assert_array_equal(seen["draws"][batch],
                                          want[rows[2 * d:2 * d + 2]])


def test_wrap_pad_episodes_pads_to_the_dp_extent_of_a_2d_mesh():
    """The JAX case of tests/test_parallel.py:138-156 in the port's terms:
    on dp=4 x tp=2, 3 episodes pad to 4, not 8; the 1-D mesh of 8 pads to
    8."""
    mesh = Mesh(0, 8, CPU, 2, tp_group=object())
    assert mesh.shape == {"dp": 4, "tp": 2}
    xb = torch.arange(15.0).reshape(3, 5)
    padded, b = wrap_pad_episodes(xb, mesh)
    assert b == 3 and padded.shape[0] == 4
    assert torch.equal(padded[3], xb[0])
    xb4 = torch.ones(4, 5)
    assert wrap_pad_episodes(xb4, mesh)[0] is xb4
    assert wrap_pad_episodes(xb, Mesh(0, 8, CPU))[0].shape[0] == 8
    np.testing.assert_array_equal(  # rank 5: dp coordinate 2
        shard_episode_batch(np.arange(8), Mesh(
            5, 8, CPU, 2, tp_group=object())).numpy(), [4, 5])


# -- (d) refusals ------------------------------------------------------------------

def test_make_mesh_2d_refuses_a_world_not_dp_tp():
    with pytest.raises(RuntimeError, match="spawn_ranks or torchrun"):
        make_mesh_2d(2, 2, "cpu")
    with pytest.raises(ValueError, match="devices available"):
        make_mesh_2d(os.cpu_count(), 2, "cpu")
    assert not dist.is_initialized()
    make_mesh(1, "cpu")
    try:
        with pytest.raises(ValueError, match=r"needs 2 ranks, the process "
                                             r"group has 1"):
            make_mesh_2d(2, 1, "cpu")
        mesh = make_mesh_2d(1, 1, "cpu")
        assert mesh.shape == {"dp": 1, "tp": 1}
        assert (mesh.dp_rank, mesh.tp_rank) == (0, 0)
    finally:
        dist.destroy_process_group()


def test_tp_sharding_refuses_without_a_tp_group_or_a_right_chunk():
    x = _episodes((WAY, SHOT + QUERY, PX, PX, 3))
    model = _dkt().init(torch.from_numpy(x))
    name = "feature.trunk.1.C.weight"
    one_d = Mesh(0, 2, CPU)
    with pytest.raises(ValueError, match="needs a 2-D mesh"):
        tensor_sharding_rules(model, one_d)  # no tp axis
    with pytest.raises(ValueError, match="needs a 2-D mesh"):
        make_sharded_train_step(model, one_d, {name: (MODEL_AXIS, 0)})
    with pytest.raises(ValueError, match="names no parameter"):
        shard_parameters(model, one_d, {"feature.nothing": None})
    # a mesh whose tp group is never reached: every check raises before
    fake = Mesh(1, 4, CPU, 2, tp_group=object())
    with pytest.raises(ValueError, match="does not divide"):
        TensorParallelChunk(1, Mesh(0, 6, CPU, 3, tp_group=object()),
                            torch.Size([64, 64, 3, 3]))
    full = model.feature.trunk[1].C.weight.detach().clone()
    shard_parameters(model, fake, {name: (MODEL_AXIS, 0)})
    conv = model.feature.trunk[1].C
    stored = conv.weight
    assert stored.shape == (32, 64, 3, 3)
    assert torch.equal(stored, full[32:])  # tp coordinate 1
    stored.data = torch.zeros(16, 64, 3, 3)
    with pytest.raises(ValueError, match="a tp chunk of shape"):
        gather_state(model)


# -- the zoo on the episode-parallel path ------------------------------------------

def _grads_close(got: dict, want: dict) -> None:
    """The zoo test's gradient rule between two port gradient dicts."""
    assert set(got) == set(want)
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        if name.endswith(".C.bias"):
            scale = np.abs(want[name[:-4] + "weight"].numpy()).max()
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-3 * scale, name
        else:
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max() + 1e-7, name


@pytest.mark.parametrize("name", ZOO)
def test_zoo_sharded_step_matches_one_process(runs, name):
    """One sharded step on 2 ranks (two episodes each) against the one
    process step on the 4 episodes: loss, gradients, then the sharded
    eval against the one-process eval of the weights after the step."""
    params, xb = runs["zoo"][name]
    got = runs["dp"][name]
    _, one, px = _episodic_pair(name)
    one = _load(one, params, px, xb[0])
    loss1 = float(one.train_step(torch.from_numpy(xb))["loss"])
    _close(got["loss"], loss1)
    _grads_close(got["grads"],
                 {n: p.grad for n, p in one.named_parameters()})
    one.load_state_dict(got["state"])
    want = one.batch_correct(torch.from_numpy(xb)).numpy()
    assert got["accs"].shape == (ZOO_B,)
    np.testing.assert_allclose(got["accs"].numpy(), want, atol=1e-4)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_sharded_step_matches_jax_sharded_step(runs, name):
    """The loss and gradients against the JAX package's on a 2-device
    mesh of the virtual CPU devices, episodes sharded (MAML sums its
    episodes' losses on both sides)."""
    params, xb = runs["zoo"][name]
    jm, tm, px = _episodic_pair(name)
    jmesh = jpar.make_mesh(2)
    grad_fn = jax.jit(jax.value_and_grad(jm.batch_loss_train, has_aux=True),
                      in_shardings=(jpar.replicated(jmesh),
                                    jpar.episode_sharding(jmesh)))
    (want, _), jgrads = grad_fn(
        jpar.replicate_tree(jax.tree.map(jnp.asarray, params), jmesh),
        jpar.shard_episode_batch(jnp.asarray(xb), jmesh))
    got = runs["dp"][name]
    _close(got["loss"], float(want))
    tm = _load(tm, params, px, xb[0])
    for n, p in tm.named_parameters():
        p.grad = got["grads"][n]
    _check_grads(tm, jgrads, px)


def test_baseline_batch_sharded_step_matches_one_process(runs):
    """BaselineTrain's minibatch of 8 split over 2 ranks: the BatchNorm
    statistics are the whole minibatch's (summed over the ranks), so the
    loss, the gradients and the merged running averages are the
    one-process step's."""
    xs, ys, bstate = runs["base"]
    one = BaselineTrain(tbb.ConvNet(2), 4, device="cpu").init(
        torch.from_numpy(xs))
    one.load_state_dict(bstate)
    loss1 = float(one.train_step(torch.from_numpy(xs),
                                 torch.from_numpy(ys))["loss"])
    got = runs["dp"]["baseline"]
    _close(got["loss"], loss1)
    _grads_close(got["grads"], {n: p.grad for n, p in one.named_parameters()})
    for name, want in one.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(got["state"][name].numpy(),
                                       want.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
