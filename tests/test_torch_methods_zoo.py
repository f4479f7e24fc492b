"""The port's comparison methods (deep_kernel_transfer_tpu_torch/methods)
against the JAX package's, on one tiny batch of episodes and the same
weights (carried across with utils.convert.params_from_jax):

  * ProtoNet, MatchingNet (its bi-LSTM G encoder and attention-LSTM FCE),
    RelationNet with the mse and softmax losses, MAML second order and
    first order (maml_approx), and BaselineTrain with the softmax and the
    DistLinear head: eval-mode scores, the train loss and its gradient in
    every parameter;
  * RelationNet's test-time adaptation with the JAX package's
    permutations, and BaselineFinetune with the JAX package's head init and
    permutations; the batched finetune equals the one-episode one;
  * factory.build_method for every classification method.

Trunks are ConvNet(depth=2) at 12 px (3x3x64 = 576 flat features, so the
HWC/CHW permutation of the heads and of MatchingNet's LSTM units is not
the identity) and its no-pool form at 38 px (8x8x64 maps). BatchNorm
parameters and running statistics are randomised. f32 trunks on both
sides. Tolerances: scores and losses 1e-5 of the largest value or 1e-5
absolute, the larger; gradients 2e-2 relative to each tensor's largest
entry (tests/test_pallas_mll.py:39,45).
"""
import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_kernel_transfer_tpu.methods import (MAML as JMAML,
                                              BaselineFinetune as JFinetune,
                                              BaselineTrain as JBaseline,
                                              MatchingNet as JMatchingNet,
                                              ProtoNet as JProtoNet,
                                              RelationNet as JRelationNet)
from deep_kernel_transfer_tpu.models import backbones as jbb
from deep_kernel_transfer_tpu_torch import factory
from deep_kernel_transfer_tpu_torch.methods import (MAML, BaselineTrain,
                                                    MatchingNet, ProtoNet,
                                                    RelationNet)
from deep_kernel_transfer_tpu_torch.methods import baseline as tbaseline
from deep_kernel_transfer_tpu_torch.models import backbones as tbb
from deep_kernel_transfer_tpu_torch.utils.convert import (flatten_perm,
                                                          state_from_jax)
from torch_test_threads import one_thread  # noqa: F401

B, WAY, SHOT, QUERY = 2, 3, 2, 2
PX, NP_PX = 12, 38


def _randomise_bn(tree, rng):
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "mean" or (k == "bias" and "scale" in tree):
            out[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
        else:
            out[k] = _randomise_bn(v, rng)
    return out


def _episodes(px, shot=SHOT, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (B, WAY, shot + QUERY, px, px, 3)).astype(np.uint8)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err < tol * max(1.0, np.abs(want).max()), err


def _jax_params(jm, x_example):
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                              x_example).params)
    return _randomise_bn(params, np.random.RandomState(1))


def _load(tm, params, px, example):
    tm.init(torch.from_numpy(example), torch.Generator().manual_seed(0))
    state = state_from_jax(params, tm, px)
    tm.load_state_dict({k: torch.tensor(v) for k, v in state.items()},
                       strict=True)
    return tm


def _check_grads(tm, jgrads, px):
    """Port parameter gradients against the JAX gradient tree mapped onto
    the port's names (an LSTM's flax bias feeds both bias_ih and
    bias_hh). A conv bias right before a train-mode BatchNorm has an exact
    gradient of 0 (the normalisation removes it); there both sides must be
    rounding, below 1e-3 of the conv weight's gradient."""
    want = state_from_jax(jax.tree.map(np.asarray, jgrads), tm, px)
    grads = {name: p.grad.numpy() for name, p in tm.named_parameters()}
    checked = 0
    for name, g in grads.items():
        w = want[name.replace("bias_hh", "bias_ih")]
        if name.endswith(".C.bias"):
            scale = np.abs(grads[name[:-4] + "weight"]).max()
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-3 * scale, name
        else:
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max() + 1e-7, name
        checked += 1
    assert checked == len(list(tm.parameters()))


def _episodic_pair(name):
    """(JAX method, port method, image size) of the episodic methods."""
    if name == "protonet":
        return (JProtoNet(jbb.ConvNet(depth=2), WAY, SHOT,
                          feature_dtype="float32"),
                ProtoNet(tbb.ConvNet(2), WAY, SHOT, feature_dtype="float32",
                         device="cpu"), PX)
    if name == "matchingnet":
        return (JMatchingNet(jbb.ConvNet(depth=2), 576, WAY, SHOT,
                             feature_dtype="float32"),
                MatchingNet(tbb.ConvNet(2), 576, WAY, SHOT,
                            feature_dtype="float32", device="cpu"), PX)
    if name.startswith("relationnet"):
        loss = "mse" if name == "relationnet" else "softmax"
        return (JRelationNet(jbb.ConvNetNopool(depth=2), (8, 8, 64), WAY,
                             SHOT, loss_type=loss, feature_dtype="float32"),
                RelationNet(tbb.ConvNet(2, nopool=True), (64, 8, 8), WAY,
                            SHOT, loss_type=loss, feature_dtype="float32",
                            device="cpu"), NP_PX)
    approx = name == "maml_approx"
    return (JMAML(jbb.ConvNet(depth=2), WAY, SHOT, approx=approx,
                  task_update_num=3),
            MAML(tbb.ConvNet(2), WAY, SHOT, approx=approx,
                 task_update_num=3, device="cpu"), PX)


METHODS = ["protonet", "matchingnet", "relationnet", "relationnet_softmax",
           "maml", "maml_approx"]


@pytest.fixture(scope="module", params=METHODS)
def episodic(request):
    jm, tm, px = _episodic_pair(request.param)
    xb = _episodes(px)
    params = _jax_params(jm, jnp.asarray(xb[0]))
    return dict(name=request.param, jm=jm, tm=_load(tm, params, px, xb[0]),
                params=params, xb=xb, px=px)


def test_scores_match_jax(episodic):
    jm, tm, xb = episodic["jm"], episodic["tm"], episodic["xb"]
    want = jm.batch_scores(jax.tree.map(jnp.asarray, episodic["params"]),
                           jnp.asarray(xb))
    got = tm.batch_scores(torch.from_numpy(xb))
    _close(got.numpy(), want)
    _close(tm.batch_correct(torch.from_numpy(xb)).numpy(),
           jm.batch_correct(jax.tree.map(jnp.asarray, episodic["params"]),
                            jnp.asarray(xb)))


def test_train_loss_and_gradients_match_jax(episodic):
    """One train step's loss (mean over episodes; MAML's sum) and every
    parameter's gradient; then the step itself runs and merges the
    running averages."""
    jm, tm, xb = episodic["jm"], episodic["tm"], episodic["xb"]
    params = jax.tree.map(jnp.asarray, episodic["params"])
    (want, _), jgrads = jax.value_and_grad(
        jm.batch_loss_train, has_aux=True)(params, jnp.asarray(xb))
    tm.zero_grad()
    loss, _ = tm.batch_loss_train(torch.from_numpy(xb))
    loss.backward()
    _close(float(loss.detach()), float(want))
    _check_grads(tm, jgrads, episodic["px"])
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    assert torch.isfinite(tm.train_step(torch.from_numpy(xb))["loss"])
    after = tm.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert any("running_mean" in k for k in moved) != episodic[
        "name"].startswith("maml")  # MAML keeps no running averages


@pytest.mark.parametrize("loss_type", ["softmax", "dist"])
def test_baseline_train_matches_jax(loss_type):
    x = np.random.RandomState(4).randint(0, 256, (6, PX, PX, 3)).astype(
        np.uint8)
    y = np.array([0, 3, 1, 3, 2, 0])
    jm = JBaseline(jbb.ConvNet(depth=2), 4, loss_type=loss_type)
    params = jax.tree.map(np.asarray,
                          jm.init(jax.random.PRNGKey(2), jnp.asarray(x)).params)
    params = _randomise_bn(params, np.random.RandomState(5))
    tm = BaselineTrain(tbb.ConvNet(2), 4, loss_type=loss_type, device="cpu")
    tm.init(torch.from_numpy(x))
    state = state_from_jax(params, tm, PX)
    tm.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    (want, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y))
    loss, stats = tm.loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    _close(float(loss.detach()), float(want))
    _check_grads(tm, jgrads, PX)
    assert len(stats) == 2


def _finetune_draws(key, z_support, n_way, loss_type):
    """The JAX BaselineFinetune's head init and 100 permutations for
    `key`, in the port's batched layout."""
    head = JFinetune(z_support.shape[-1], n_way, SHOT, loss_type=loss_type)
    k_init, k_perm = jax.random.split(key)
    p = jax.tree.map(np.asarray, head.head.init(k_init, z_support))["params"]
    heads = ([p["v"].T, p["g"][:, None]] if loss_type == "dist"
             else [p["kernel"].T, p["bias"]])
    perms = np.stack([np.asarray(jax.random.permutation(
        k, z_support.shape[0])) for k in jax.random.split(k_perm, 100)])
    return head, heads, perms


@pytest.mark.parametrize("loss_type", ["softmax", "dist"])
def test_baseline_finetune_matches_jax(loss_type):
    """Per episode against the JAX BaselineFinetune on the same head init
    and permutations (a support of 6 makes the last minibatch of each
    epoch wrap round); the batched run equals the one-episode runs."""
    rng = np.random.RandomState(6)
    z = rng.randn(3, WAY, SHOT + QUERY, 20).astype(np.float32)
    wants, heads, perms = [], [], []
    for e in range(3):
        key = jax.random.PRNGKey(10 + e)
        head, h, p = _finetune_draws(
            key, z[e, :, :SHOT].reshape(WAY * SHOT, -1), WAY, loss_type)
        wants.append(np.asarray(head.episode_scores(key, jnp.asarray(z[e]))))
        heads.append(h)
        perms.append(p)
    batched = tbaseline.finetune_scores(
        torch.from_numpy(z), SHOT, loss_type,
        heads=[torch.from_numpy(np.stack(t)) for t in zip(*heads)],
        perms=torch.from_numpy(np.stack(perms)))
    for e in range(3):
        one = tbaseline.finetune_scores(
            torch.from_numpy(z[e:e + 1]), SHOT, loss_type,
            heads=[torch.from_numpy(t[None]) for t in heads[e]],
            perms=torch.from_numpy(perms[e][None]))[0]
        _close(one.numpy(), wants[e])
        _close(batched[e].numpy(), one.numpy(), 1e-6)


@pytest.mark.parametrize("loss_type", ["mse", "softmax"])
def test_relationnet_adaptation_matches_jax(loss_type):
    """adapted_scores_from_features of two 5-shot episodes against the JAX
    package's, with its permutations for each episode's key."""
    shot = 5
    jm = JRelationNet(jbb.ConvNetNopool(depth=2), (8, 8, 64), WAY, shot,
                      loss_type=loss_type, feature_dtype="float32")
    xb = _episodes(NP_PX, shot, seed=7)
    params = _jax_params(jm, jnp.asarray(xb[0]))
    tm = _load(RelationNet(tbb.ConvNet(2, nopool=True), (64, 8, 8), WAY,
                           shot, loss_type=loss_type,
                           feature_dtype="float32", device="cpu"),
               params, NP_PX, xb[0])
    jparams = jax.tree.map(jnp.asarray, params)
    with torch.no_grad():
        z, _ = tm.batch_features(torch.from_numpy(xb))
    wants, perms = [], []
    for e in range(B):
        key = jax.random.PRNGKey(20 + e)
        z_jax = jnp.asarray(z[e].permute(0, 1, 3, 4, 2).numpy())
        wants.append(np.asarray(jm.adapted_scores_from_features(
            jparams, z_jax, key)))
        perms.append(np.stack([np.asarray(jax.random.permutation(k, shot))
                               for k in jax.random.split(key, 100)]))
    got = tm.adapted_scores_from_features(
        z, perms=torch.from_numpy(np.stack(perms)))
    _close(got.numpy(), np.stack(wants))
    # the module's own weights are left as they were
    with torch.no_grad():
        own = tm.scores_from_features(z).numpy()
    _close(own,
           np.stack([np.asarray(jm.scores_from_features(
               jparams, jnp.asarray(z[e].permute(0, 1, 3, 4, 2).numpy())))
               for e in range(B)]))


@pytest.mark.parametrize("method", ["baseline", "baseline++", "DKT",
                                    "protonet", "matchingnet", "relationnet",
                                    "relationnet_softmax", "maml",
                                    "maml_approx"])
@pytest.mark.parametrize("dataset", ["miniImagenet", "omniglot"])
def test_build_method(method, dataset):
    params = argparse.Namespace(method=method, dataset=dataset,
                                model="Conv4" if dataset != "omniglot"
                                else "Conv4S", num_classes=4112,
                                feature_dtype="float32")
    tm = factory.build_method(params, 5, 5, device="cpu")
    assert type(tm).__name__ == {
        "baseline": "BaselineTrain", "baseline++": "BaselineTrain",
        "protonet": "ProtoNet", "matchingnet": "MatchingNet",
        "relationnet": "RelationNet", "relationnet_softmax": "RelationNet",
        "maml": "MAML", "maml_approx": "MAML"}.get(method, "DKT")
    if method.startswith("maml"):
        want = (32, 1, 0.1) if dataset == "omniglot" else (4, 5, 0.01)
        assert (tm.n_task, tm.task_update_num, tm.train_lr) == want
        assert tm.approx == (method == "maml_approx")
    if method.startswith("relationnet"):
        assert tm.feat_shape == ((64, 5, 5) if dataset == "omniglot"
                                 else (64, 19, 19))
        assert tm.feature.nopool
    if method.startswith("baseline"):
        assert tm.loss_type == ("dist" if method == "baseline++"
                                else "softmax")
        params.num_classes = 200
        with pytest.raises(ValueError, match="num_classes") if (
                dataset == "omniglot") else _nothing():
            factory.build_method(params, 5, 5, device="cpu")


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_flatten_perm_of_pooled_trunks_is_the_identity():
    assert (flatten_perm(tbb.ResNet10(), 224) == np.arange(512)).all()
    assert not (flatten_perm(tbb.ConvNet(2), PX) == np.arange(576)).all()
