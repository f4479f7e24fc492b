"""A/B: what the jitter probe of psd_safe_cholesky costs in the GP tail.

    python -m deep_kernel_transfer_tpu_torch.benchmarks.gp_probe_ab

Port of JAX benchmarks/gp_probe_ab.py:40-97. `gp/exact.py::
psd_safe_cholesky` factors a detached copy first and, while any matrix of
the batch fails, retries it with more jitter; then it factors again with
gradients. DKT's noisy Gram is PD by construction (a PSD kernel plus a
fixed noise of 0.1), so `ExactGP(assume_pd=True)` skips the probe with a
bit-identical result. This times the value and gradient, in the GP
parameters and the features, of the batched bncossim sum-MLL tail that
`batch_loss_train` runs after the trunk, on the dense route
(force_dense=True), at [B=32 episodes, 5 ways, N=100, D=1600], with the
probe (assume_pd=False) and without, the arms taking turns.

The port's probe decides on the host: `bool(bad.any())` waits for the
probe's factorisation before the loop goes on (one host sync a call),
where the JAX probe is an in-graph while_loop. So the saving here is a
host round trip and a batched factorisation, not what JAX saves.

Both arms are first checked bit-identical (value and every gradient).
Rows gp_probe_ab_tail_probed_ms, _assume_pd_ms, _saved_ms (the JAX key
names) go to --report (studies_report.json beside this file) with the
card's name and power limit. Runs on CUDA; `main(argv, device="cpu")`
runs on the CPU.
"""
from __future__ import annotations

import argparse
import os

import torch

from ._timing import card_of, merge_report, ms_in_turns
from .profile_step import REPORT

N_WAY, N_TOTAL, D, NOISE = 5, 20, 1600, 0.1


def tail_inputs(b: int, device, seed: int = 1) -> torch.Tensor:
    """Unit-norm features [b, N_WAY * N_TOTAL, D] from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((b, N_WAY * N_TOTAL, D), generator=gen, device=device)
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


def tail(assume_pd: bool, z: torch.Tensor):
    """fn() -> (loss, gradients in the GP leaves and in z) of the mean
    over episodes of -sum over ways of the per-way MLL."""
    from ..gp import ExactGP, GaussianLikelihood, make_kernel
    from ..gp.exact import init_batched
    from ..methods.base import one_vs_rest_targets
    from ..methods.dkt import _leaves

    gp = ExactGP(make_kernel("bncossim"),
                 GaussianLikelihood(trainable=False, fixed_noise=NOISE),
                 force_dense=True, assume_pd=assume_pd)
    params = init_batched(gp, N_WAY, device=z.device)
    leaves = [t.requires_grad_() for t in _leaves(params)]  # dict order
    z = z.detach().requires_grad_()
    targets = one_vs_rest_targets(N_WAY, N_TOTAL, z.device)

    def fn():
        loss = -torch.mean(torch.sum(gp.mll(params, z[:, None], targets),
                                     dim=1))
        return (loss.detach(),) + torch.autograd.grad(loss, leaves + [z])

    return fn


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=16,
                    help="calls a timing (the JAX script's R)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--report", default=REPORT)
    args = ap.parse_args(argv)

    from .._device import resolve_device

    device = resolve_device(device)
    z = tail_inputs(args.batch, device)
    arms = {"probed": tail(False, z), "assume_pd": tail(True, z)}
    outs = {name: fn() for name, fn in arms.items()}
    if not all(torch.equal(a, b) for a, b in zip(outs["probed"],
                                                 outs["assume_pd"])):
        raise AssertionError("the probe changed the tail's value or "
                             "gradients")
    times = ms_in_turns(arms, device, args.rounds, args.reps)
    rows = {"gp_probe_ab_tail_probed_ms": times["probed"][0],
            "gp_probe_ab_tail_assume_pd_ms": times["assume_pd"][0],
            "gp_probe_ab_saved_ms": times["probed"][0]
            - times["assume_pd"][0],
            "gp_probe_ab_ms_ranges": {k: [v[1], v[2]]
                                      for k, v in times.items()},
            "gp_probe_ab_card": card_of(device),
            "gp_probe_ab_protocol": (
                f"value and gradient of the batched [B={args.batch}, 5-way, "
                f"N=100, D=1600] bncossim sum-MLL tail (fixed noise 0.1, "
                f"dense route) with the psd_safe_cholesky jitter probe "
                f"against ExactGP(assume_pd=True), outputs bit-identical; "
                f"{args.reps} calls between CUDA events after a warm-up "
                f"call, median of {args.rounds} turns")}
    merge_report(os.path.abspath(args.report), rows)
    for k, v in rows.items():
        print(f"{k}: {v}", flush=True)
    return rows


if __name__ == "__main__":
    main()
