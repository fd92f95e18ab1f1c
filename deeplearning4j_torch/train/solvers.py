"""Line-search solvers — counterpart of ``deeplearning4j_tpu/train/solvers.py``:
``backtrack_line_search`` (Armijo, BackTrackLineSearch.java's constants),
``lbfgs_minimize`` (two-loop recursion over a ring of ``history`` pairs),
``cg_minimize`` (Polak-Ribière with restart), ``line_gradient_descent``
and ``Solver`` (full-batch optimization of a model's score).

The reference runs the whole optimization as one ``lax.while_loop``; here
it is a host loop over the same f32 steps, each decision (Armijo
acceptance, the curvature test, convergence) read back from the device.
The params are flattened into one f32 vector in ``jax.tree_util`` order
(``tree_leaves``), as ``ravel_pytree`` flattens them, so the iterates are
the reference's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..ops.updaters import tree_leaves, tree_unflatten

# BackTrackLineSearch.java constants
ALF = 1e-4          # Armijo sufficient-decrease constant
STEP_MAX = 100.0    # max line-search step norm
REL_TOLX = 1e-7
ABS_TOLX = 1e-4


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def backtrack_line_search(loss_f: Callable[[torch.Tensor], torch.Tensor],
                          x: torch.Tensor, f0: torch.Tensor, g: torch.Tensor,
                          direction: torch.Tensor, max_iterations: int = 5,
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Armijo backtracking: returns ``(step, f_at_step)`` with ``x + step
    * direction`` the best improving point tried (step 0 when none
    improved); the step-norm clipping is folded into the step. The step
    halves from 1 until the sufficient-decrease test holds or the step
    falls below the relative tolerance, at most ``max_iterations``
    times."""
    dnorm = torch.linalg.vector_norm(direction)
    scale = torch.where(dnorm > STEP_MAX, _f32(STEP_MAX, x) / dnorm,
                        _f32(1.0, x))
    direction = direction * scale
    slope = torch.dot(g, direction)
    test = torch.max(torch.abs(direction) / torch.clamp_min(torch.abs(x), 1.0))
    alamin = _f32(REL_TOLX, x) / torch.clamp_min(test, 1e-30)
    alam, best_alam, best_f = _f32(1.0, x), _f32(0.0, x), f0
    for _ in range(max_iterations):
        f_new = loss_f(x + alam * direction)
        ok = bool(f_new <= f0 + ALF * alam * slope)
        if bool(f_new < best_f):
            best_alam, best_f = alam, f_new
        done = ok or bool(alam < alamin)
        alam = alam * 0.5
        if done:
            break
    return best_alam * scale, best_f


class SolverResult(NamedTuple):
    params: dict
    score: float
    iterations: int
    converged: bool


def _flatten(params):
    leaves = tree_leaves(params)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in leaves])

    def unravel(x):
        out, i = [], 0
        for t in leaves:
            n = t.numel()
            out.append(x[i:i + n].reshape(t.shape).to(t.dtype))
            i += n
        return tree_unflatten(params, out)

    return flat, unravel


def _minimize(loss_fn, params0, *, algo: str, max_iterations: int,
              history: int, line_search_iterations: int, tol: float):
    x, unravel = _flatten(params0)

    def f(v):
        return loss_fn(unravel(v)).to(torch.float32)

    def f_and_grad(v):
        with torch.enable_grad():
            v = v.detach().requires_grad_()
            fv = f(v)
            (gv,) = torch.autograd.grad(fv, v)
        return fv.detach(), gv

    def f_nograd(v):
        with torch.no_grad():
            return f(v)

    fx, g = f_and_grad(x)
    n = x.shape[0]
    if algo == "lbfgs":
        S = torch.zeros((history, n), dtype=torch.float32, device=x.device)
        Y = torch.zeros_like(S)
        rho = torch.zeros((history,), dtype=torch.float32, device=x.device)
    d_prev = torch.zeros_like(x)
    g_prev = g
    k, converged = 0, False
    while k < max_iterations and not converged:
        if algo == "lbfgs":
            q, alpha = g, torch.zeros_like(rho)
            for i in range(history):
                idx = (k - 1 - i) % history
                a = rho[idx] * torch.dot(S[idx], q)
                a = torch.where(rho[idx] != 0, a, _f32(0.0, x))
                q = q - a * Y[idx]
                alpha[idx] = a
            last = (k - 1) % history
            sy = torch.dot(S[last], Y[last])
            yy = torch.dot(Y[last], Y[last])
            gamma = (sy / torch.clamp_min(yy, 1e-20) if k > 0 and bool(yy > 0)
                     else _f32(1.0, x))
            r = gamma * q
            for i in range(history):
                idx = (k - history + i) % history
                b = rho[idx] * torch.dot(Y[idx], r)
                b = torch.where(rho[idx] != 0, b, _f32(0.0, x))
                r = r + (alpha[idx] - b) * S[idx]
            d = -r
        elif algo == "cg":
            beta = (torch.dot(g, g - g_prev)
                    / torch.clamp_min(torch.dot(g_prev, g_prev), 1e-20))
            beta = torch.clamp_min(beta, 0.0) if k > 0 else _f32(0.0, x)
            d = -g + beta * d_prev
        else:  # line gradient descent
            d = -g
        if not bool(torch.dot(d, g) < 0):  # not a descent direction
            d = -g
        step, f_new = backtrack_line_search(
            f_nograd, x, fx, g, d, max_iterations=line_search_iterations)
        x_new = x + step * d
        _, g_new = f_and_grad(x_new)
        if algo == "lbfgs":
            s_vec, y_vec = x_new - x, g_new - g
            sy = torch.dot(s_vec, y_vec)
            idx = k % history
            if bool(sy > 1e-10):
                S[idx], Y[idx] = s_vec, y_vec
                rho[idx] = 1.0 / torch.clamp_min(sy, 1e-20)
            else:
                S[idx], Y[idx], rho[idx] = 0.0, 0.0, 0.0
        elif algo == "cg":
            d_prev = d
        converged = (bool(torch.abs(fx - f_new)
                          <= tol * torch.clamp_min(torch.abs(fx), 1e-12))
                     or bool(step == 0.0))
        g_prev = g
        k, x, fx, g = k + 1, x_new, f_new, g_new
    return SolverResult(unravel(x), float(fx), k, converged)


def lbfgs_minimize(loss_fn, params0, max_iterations: int = 100,
                   history: int = 4, line_search_iterations: int = 5,
                   tol: float = 1e-10) -> SolverResult:
    """LBFGS.java — history of 4 pairs by default."""
    return _minimize(loss_fn, params0, algo="lbfgs",
                     max_iterations=max_iterations, history=history,
                     line_search_iterations=line_search_iterations, tol=tol)


def cg_minimize(loss_fn, params0, max_iterations: int = 100,
                line_search_iterations: int = 5,
                tol: float = 1e-10) -> SolverResult:
    """ConjugateGradient.java — Polak-Ribière with restart."""
    return _minimize(loss_fn, params0, algo="cg",
                     max_iterations=max_iterations, history=1,
                     line_search_iterations=line_search_iterations, tol=tol)


def line_gradient_descent(loss_fn, params0, max_iterations: int = 100,
                          line_search_iterations: int = 5,
                          tol: float = 1e-10) -> SolverResult:
    """LineGradientDescent.java — steepest descent with the line
    search."""
    return _minimize(loss_fn, params0, algo="sd",
                     max_iterations=max_iterations, history=1,
                     line_search_iterations=line_search_iterations, tol=tol)


class Solver:
    """optimize/Solver.java: full-batch minimization of a model's
    inference-mode score with a line-search solver ("lbfgs",
    "conjugate_gradient" or "line_gradient_descent"); the model's params
    are replaced by the result."""

    ALGOS = {"lbfgs": lbfgs_minimize, "conjugate_gradient": cg_minimize,
             "line_gradient_descent": line_gradient_descent}

    def __init__(self, model, algo: str = "lbfgs", max_iterations: int = 100,
                 line_search_iterations: int = 5):
        if algo not in self.ALGOS:
            raise ValueError(f"Unknown algo '{algo}' (choose from "
                             f"{sorted(self.ALGOS)})")
        self.model = model
        self.algo = algo
        self.max_iterations = max_iterations
        self.line_search_iterations = line_search_iterations
        self.result: Optional[SolverResult] = None

    def optimize(self, x, y) -> SolverResult:
        model = self.model
        if model.params is None:
            model.init()
        state = model.state
        x = torch.as_tensor(x, device=model.device)
        y = torch.as_tensor(y, device=model.device)

        def loss_fn(p):
            return model.score(p, state, x, y, training=False)[0]

        self.result = self.ALGOS[self.algo](
            loss_fn, model.params, max_iterations=self.max_iterations,
            line_search_iterations=self.line_search_iterations)
        model.params = self.result.params
        return self.result
