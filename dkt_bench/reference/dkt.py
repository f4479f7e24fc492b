"""DKT's training steps and eval head in the plain reference (see
common.py), and the weights and split that a run draws from its seed and
hands to both the program and the reference."""
from __future__ import annotations

import importlib

import torch

from .common import (adam, augment, augment_draws, bncossim, gp_mll,
                     gp_posterior_mean, sample_ids)

RUNNING = ("bn_running_mean", "bn_running_var")


def trunk(model: str):
    """reference/trunk_<model>.py."""
    return importlib.import_module(f"{__package__}.trunk_{model}")


def layout(cfg: dict, n_way: int) -> dict:
    """name -> (shape, kind) of every parameter and BatchNorm buffer, in
    the program's state_dict names: the trunk's, the bncossim head's and
    the per-way GP's."""
    t = trunk(cfg["model"])
    out = dict(t.param_shapes(cfg["image_size"]))
    d = t.feat_dim(cfg["image_size"])
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"feature.trunk.bn_out.{leaf}"] = ((d,), "bn_" + leaf)
    out["gp.mean.constant"] = ((n_way,), "gp_mean")
    out["gp.kernel.raw_outputscale"] = ((n_way,), "gp_scale")
    return out


def trainable(cfg: dict, n_way: int) -> list[str]:
    return [k for k, (_, kind) in layout(cfg, n_way).items()
            if kind not in RUNNING]


def _zero(z, u):
    return torch.zeros_like(z)


def _one(z, u):
    return torch.ones_like(z)


def _normal(sd: float):
    return lambda z, u: sd * z


def _uniform(lo: float, width: float):
    return lambda z, u: lo + width * u


# kind -> (initial law, `trained` law), each of (z, u): the leaf's own
# slices of the standard normal and the uniform draw
LAWS = {
    "conv_bias": (_zero, _normal(0.01)),
    "bn_weight": (_one, _uniform(0.5, 1.0)),
    "bn_bias": (_zero, _normal(0.1)),
    "bn_running_mean": (_zero, _normal(0.1)),
    "bn_running_var": (_one, _uniform(0.5, 1.5)),
    "gp_mean": (_zero, _normal(0.1)),
    "gp_scale": (_zero, _normal(0.5)),
    "linear": (_normal(0.02), _normal(0.02)),
    "linear_bias": (_zero, _normal(0.01)),
    "ln_weight": (_one, _uniform(0.5, 1.0)),
    "ln_bias": (_zero, _normal(0.1)),
    "table": (_normal(0.02), _normal(0.02)),
}


def _draw_leaf(t, name: str, kind: str, shape, z, u, trained: bool):
    """One leaf by its kind's law: a convolution [out, in, k, k] N(0, 2 /
    (k k out)) in both laws, a kind of LAWS by its law, any other kind by
    the trunk module t's own `draw_leaf(kind, shape, z, u, trained)`,
    which returns None for a kind it does not know either."""
    if kind == "conv":
        return z * (2.0 / (shape[0] * shape[2] * shape[3])) ** 0.5
    if kind in LAWS:
        return LAWS[kind][trained](z, u)
    own = getattr(t, "draw_leaf", None)
    leaf = own(kind, shape, z, u, trained) if own is not None else None
    if leaf is None:
        raise KeyError(f"no law for leaf {name!r} of kind {kind!r}: neither "
                       f"reference.dkt.LAWS nor {t.__name__}.draw_leaf "
                       "knows it")
    return leaf


def draw_weights(cfg: dict, n_way: int, gen: torch.Generator, device,
                 trained: bool = False) -> dict:
    """Every parameter and buffer, float32 on `device`, from `gen` in two
    calls (one normal, one uniform draw for all leaves, sliced in
    `layout`'s order). The initial law of the reference: convolutions N(0,
    2 / (k k out)), linear weights and bias tables N(0, 0.02^2), zero conv
    and linear biases, unit BatchNorms and LayerNorms, the GP's raw
    parameters 0. `trained` draws a state such as training leaves instead:
    BatchNorm and LayerNorm scales U(0.5, 1.5), shifts N(0, 0.1), running
    means N(0, 0.1), running variances U(0.5, 2), conv and linear biases
    N(0, 0.01), the GP's constant means N(0, 0.1) and raw outputscales
    N(0, 0.5); convolutions, linear weights and tables as initially.
    Linear weights and tables depart from ViT's and Swin's
    trunc_normal_(std=.02) in one way: drawn untruncated, so about 4.6% of
    them lie beyond two standard deviations. A kind that neither LAWS nor
    the trunk's `draw_leaf` knows raises KeyError."""
    t = trunk(cfg["model"])
    shapes = layout(cfg, n_way)
    sizes = [torch.Size(s).numel() for s, _ in shapes.values()]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, (shape, kind)), n in zip(shapes.items(), sizes):
        z = normal[at:at + n].view(shape)
        u = uniform[at:at + n].view(shape)
        at += n
        out[name] = _draw_leaf(t, name, kind, shape, z, u, trained)
    return out


def make_split(spec: dict, gen: torch.Generator, device) -> dict:
    """A split drawn on `device`: `images` [n_class * per_class, side,
    side, 3] uint8 noise in one call, class c holding images c*per_class
    onwards; `table` [n_class, max(per_class, 128)] of image ids, slot j of
    a class being its image j mod per_class; `counts` [n_class]."""
    n_class, per, side = spec["n_class"], spec["per_class"], spec["side"]
    images = torch.randint(0, 256, (n_class * per, side, side, 3),
                           generator=gen, device=device, dtype=torch.uint8)
    width = max(per, 128)
    table = (torch.arange(n_class, device=device)[:, None] * per
             + torch.arange(width, device=device)[None, :] % per)
    counts = torch.full((n_class,), per, dtype=torch.int64, device=device)
    return {"images": images, "table": table, "counts": counts}


def draw_episodes(split: dict, gen, traffic: dict, size: int, batch: int,
                  law: str = "stated"):
    """One batch of episodes [batch, W, S+Q, size, size, 3] uint8, drawn
    from `gen` as the program's feed draws it: the ids, then (with
    augmentation) every image's crop, jitter and flip."""
    w, k = traffic["n_way"], traffic["n_support"] + traffic["n_query"]
    x = split["images"][sample_ids(split["table"], split["counts"], gen, w, k,
                                   batch)]
    if traffic["augment"]:
        flat = x.reshape((-1,) + tuple(x.shape[-3:]))
        draws = augment_draws(gen, flat.shape[0], flat.shape[1], size,
                              flat.device)
        x = augment(flat, draws, size, law).reshape(
            (batch, w, k, size, size, 3))
    return x


def features(cfg: dict, p: dict, x, train: bool, law: str, stats: dict):
    """[B, W*(S+Q), D] float32 bncossim features of episodes x."""
    b = x.shape[0]
    size = x.shape[-2]
    z = trunk(cfg["model"]).forward(p, x.reshape(-1, size, size, 3), train,
                                    b if train else 1, law, stats)
    z = bncossim(p, z, train, b if train else 1, stats, law)
    return z.reshape(b, -1, z.shape[-1])


def batch_loss(cfg: dict, traffic: dict, p: dict, leaves: dict, x, law: str,
               stats: dict):
    """-(sum over ways of the MLL) averaged over the episodes x, with
    per-episode BatchNorm statistics (stats gets the running averages);
    `leaves` are the trainable leaves, `p` the rest."""
    w, k = traffic["n_way"], traffic["n_support"] + traffic["n_query"]
    z = features(cfg, {**p, **leaves}, x, True, law, stats)
    return -gp_mll(leaves, z, w, k, cfg["gp_noise"], law).sum(1).mean()


def exact_grad(cfg: dict, traffic: dict, weights: dict, x) -> dict:
    """The loss's gradient in float64 on the episodes x: a leaf whose
    gradient is nought in exact arithmetic, as a bias under a training-mode
    BatchNorm is, reads nought here to float64's rounding."""
    names = trainable(cfg, traffic["n_way"])
    p = {n: v.detach().to(torch.float64) for n, v in weights.items()}
    leaves = {n: p[n].clone().requires_grad_(True) for n in names}
    loss = batch_loss(cfg, traffic, p, leaves, x, "float64", {})
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    return {n: g.detach().cpu() for n, g in zip(names, grads)}


def train_steps(cfg: dict, traffic: dict, weights: dict, split: dict,
                feed_seed: int, steps: int, law: str = "stated",
                exact_episodes: int = 0) -> dict:
    """`steps` training steps from `weights` on the feed drawn from
    feed_seed: per-episode BatchNorm statistics, -(sum over ways of the
    MLL) averaged over episodes, Adam at the GP's and the trunk's rates,
    then the running averages merged. Returns the episode batches
    (`inputs`, uint8 on the host), each step's loss, the first step's
    gradient (`grad1`) and every leaf after the last step (`params`);
    with exact_episodes, also the float64 gradient on that many episodes
    of the first batch (`grad_exact`)."""
    device = split["images"].device
    gen = torch.Generator(device=device).manual_seed(feed_seed)
    w, b = traffic["n_way"], traffic["episode_batch"]
    names = trainable(cfg, w)
    lrs = {n: cfg["gp_lr"] if n.startswith("gp.") else cfg["feature_lr"]
           for n in names}
    p = {n: v.clone() for n, v in weights.items()}
    state, out = {}, {"inputs": [], "losses": [], "grad1": None}
    for t in range(1, steps + 1):
        x = draw_episodes(split, gen, traffic, cfg["image_size"], b, law)
        out["inputs"].append(x.cpu())
        leaves = {n: p[n].detach().clone().requires_grad_(True) for n in names}
        stats: dict = {}
        loss = batch_loss(cfg, traffic, p, leaves, x, law, stats)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[n] for n in names])))
        adam(p, grads, state, lrs, t, tuple(cfg["adam"]["betas"]),
             cfg["adam"]["eps"])
        for name, (mean, var) in stats.items():
            p[name + ".running_mean"] = mean
            p[name + ".running_var"] = var
        out["losses"].append(float(loss.detach()))
        if t == 1:
            out["grad1"] = {n: g.detach().cpu() for n, g in grads.items()}
        del leaves, grads, loss, stats
    out["params"] = {n: v.detach().cpu() for n, v in p.items()}
    if exact_episodes:
        del p, state
        first = out["inputs"][0][:exact_episodes].to(device)
        out["grad_exact"] = exact_grad(cfg, traffic, weights, first)
    return out


@torch.no_grad()
def eval_means(cfg: dict, traffic: dict, weights: dict, split: dict,
               protocol_seed: int, wanted, law: str = "stated") -> dict:
    """{batch index: [b, W*Q, W] posterior means} of the wanted batches of
    one protocol drawn from protocol_seed: its full batches of
    episode_batch episodes, then the remainder as one smaller batch."""
    device = split["images"].device
    gen = torch.Generator(device=device).manual_seed(protocol_seed)
    full, rem = divmod(traffic["protocol_episodes"], traffic["episode_batch"])
    sizes = [traffic["episode_batch"]] * full + ([rem] if rem else [])
    wanted = set(wanted)
    out = {}
    for j, b in enumerate(sizes):
        if j > max(wanted, default=-1):
            break
        x = draw_episodes(split, gen, traffic, cfg["image_size"], b, law)
        if j in wanted:
            z = features(cfg, weights, x, False, law, {})
            out[j] = gp_posterior_mean(weights, z, traffic["n_way"],
                                       traffic["n_support"], cfg["gp_noise"],
                                       law).cpu()
    return out
