"""Seed sweep of ``test_torch_layers.py::test_loss_matches_reference``: every
loss in ``LOSS_NAMES``, both variants, seeds 0..N-1, counting the cases
whose loss value misses the test's bound (4e-6 of the larger of |loss| and
the mean |term| summed, ``_term_scale``) and the old bound (4e-6 of the
larger of |loss| and 1e-3), and whose gradient misses 4e-6 relative.

    JAX_PLATFORMS=cpu python tests/loss_seed_sweep.py [--seeds 400] [--workers 6]

Prints one JSON line per (loss, variant) and the totals.
"""

import argparse
import json
import multiprocessing
import os
import sys


def _sweep(args):
    name, seeds = args
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.dirname(here))
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_torch_layers as T

    out = {}
    for variant in ("plain", "mask_weights_3d"):
        old = new = grad = 0
        worst = 0.0
        for seed in range(seeds):
            rng = np.random.default_rng(seed)
            shape = (4, 6) if variant == "plain" else (3, 5, 4)
            p, y = T._loss_inputs(name, rng, shape)
            mask = weights = None
            if variant != "plain":
                mask = (rng.random(shape[:2]) < 0.7).astype(np.float32)
                weights = rng.random(shape[-1]).astype(np.float32) + 0.5
            jfn, tfn = T.JLoss.get(name), T.TLoss.get(name)

            def jl(pp):
                return jfn(pp, jnp.asarray(y),
                           mask=None if mask is None else jnp.asarray(mask),
                           weights=None if weights is None
                           else jnp.asarray(weights))

            lj, gj = jax.value_and_grad(jl)(jnp.asarray(p))
            pt = torch.from_numpy(p).requires_grad_()
            lt = tfn(pt, torch.from_numpy(y),
                     mask=None if mask is None else torch.from_numpy(mask),
                     weights=None if weights is None
                     else torch.from_numpy(weights))
            (gt,) = torch.autograd.grad(lt, pt)
            d = abs(float(lt.detach()) - float(lj))
            old += d > 4e-6 * max(abs(float(lj)), 1e-3)
            scale = max(abs(float(lj)),
                        T._term_scale(jfn, name, p, y, mask, weights))
            new += d > 4e-6 * scale
            worst = max(worst, d / (4e-6 * scale))
            grad += T._rel(gt.numpy(), gj) > 4e-6
        out[f"{name}/{variant}"] = {"old_misses": int(old),
                                    "new_misses": int(new),
                                    "grad_misses": int(grad),
                                    "worst_share_of_bound": worst}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=400)
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.dirname(here))
    from deeplearning4j_tpu.ops import losses

    names = list(losses.names())
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(args.workers) as pool:
        results = pool.map(_sweep, [(n, args.seeds) for n in names])
    total = {"cases": 0, "old_misses": 0, "new_misses": 0, "grad_misses": 0}
    for res in results:
        for key, row in sorted(res.items()):
            print(json.dumps({key: row}))
            total["cases"] += args.seeds
            for k in ("old_misses", "new_misses", "grad_misses"):
                total[k] += row[k]
    print(json.dumps({"total": total}))


if __name__ == "__main__":
    main()
