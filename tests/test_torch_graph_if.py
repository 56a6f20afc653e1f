"""The IF-node structure of the port's captured FGMRES (solver/graph_if.py)
and the plain twins of its two control kernels, on the CPU.

  - RecordingControl, a CPU stand-in for graph_if.GraphControl: it runs
    each node's body where its handle's condition holds (set, as on the
    card, by the compare-and-set kernel's twin or the Givens update's twin)
    and logs every node reached. gmres_device under it gives the eager
    (masked) control's x, iterations and residual bit for bit, and for a
    cycle that stops after iteration k of m it reaches what
    chip_smoke.chain_nodes(k, m, GROUP) says: one group node per GROUP
    iterations at the cycle's depth, the inner nodes of the groups that
    began live one deeper, k of them live; the first iteration's node
    decided by the compare-and-set kernel, every later live one by the
    Givens update before it, a dead one by it or by nothing (the graph's
    default, 0); the blocked path's second passes and the restart guards
    decided by the compare-and-set kernel; no generic (set-kernel) node.
  - The compare-and-set kernel's twin (cond_plain, and cond_set on CPU
    tensors) equal to torch's own expressions of the decisions it replaces
    (hn < 0.7 * wn0, beta > tol, res > tol, flag == 0) and to NumPy's
    arithmetic at the same dtype, at f32 and f64, on values that straddle
    the product's rounding (chip_smoke.straddling: at f32 products that
    round otherwise when 0.7 * wn0 is formed at f64, so a twin that formed
    it so would fail); its refusals.
  - The Givens twin sets the next node's condition to the new live, and a
    dead call sets none.
"""

import sys

import numpy as np
import pytest
import torch

from chip_smoke import chain_nodes, straddling
from fvens_tpu_torch.solver import graph_if
from fvens_tpu_torch.solver.givens_kernels import givens_plain
from fvens_tpu_torch.solver.graph_if import (GREATER, GROUP, LESS, ZERO,
                                             Handle, NodeControl, cond_plain,
                                             cond_set)
from fvens_tpu_torch.solver.linear import EAGER, gmres_device

N = 256


class RecordingControl(NodeControl):
    """A CPU stand-in for GraphControl: a node's body runs where its
    handle's condition holds; each node reached is logged with its depth,
    its condition, who set it and the form that made it ("group",
    "iteration", "cmp" or "set_if")."""
    KINDS = {"run_chain": "group", "_group": "iteration",
             "run_if_cmp": "cmp"}

    def __init__(self):
        self.log, self.depth, self.made = [], 0, 0

    def handle(self):
        self.made += 1
        return Handle(self.made)

    def _enter(self, entry, live, body):
        self.log.append(dict(entry, depth=self.depth, live=live))
        if live:
            self.depth += 1
            try:
                body(None)
            finally:
                self.depth -= 1

    def node(self, handle, body):
        kind = self.KINDS[sys._getframe(1).f_code.co_name]
        live = handle.cond is not None and bool(handle.cond)
        self._enter(dict(kind=kind, set_by=handle.set_by), live, body)

    def run_if(self, pred, body):
        self._enter(dict(kind="set_if", set_by="set_if"), bool(pred), body)


def _system(n=N, seed=11):
    """A dense (n, n) system on (64, 4) vectors (diag(1..50) plus a small
    random part), preconditioned by nothing: FGMRES(m) takes 15 iterations
    to rtol 1e-2 at m = 24, 31 to 1e-4 at m = 40, 45 to 1e-6 at m = 60."""
    rng = np.random.default_rng(seed)
    d = np.linspace(1.0, 50.0, n)
    A = torch.from_numpy(np.diag(d) + 0.2 * rng.standard_normal((n, n))
                         / np.sqrt(n))
    b = torch.from_numpy(rng.standard_normal((n // 4, 4)))
    return (lambda v: (A @ v.reshape(-1)).reshape(v.shape)), \
        (lambda v: v.clone()), b


def _cycles(log):
    """The log of one gmres_device call cut into cycles: [(restart guard
    entry or None, [entries of the cycle's chain])]; a second pass sits in
    the chain after its iteration."""
    out = []
    for e in log:
        if e["kind"] == "cmp" and e["depth"] == 0:
            out.append((e, []))
        elif e["kind"] == "group" and e["depth"] == 0 and not out:
            out.append((None, [e]))
        else:
            out[-1][1].append(e)
    return out


def _iterations(chain):
    return [e for e in chain if e["kind"] in ("group", "iteration")]


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("m,rtol,k", [(24, 1e-2, 15), (40, 1e-4, 31),
                                      (60, 1e-6, 45), (16, 1e-8, 16)])
def test_one_cycle_reaches_the_chain_of_its_live_iterations(blocked, m, rtol,
                                                            k):
    """One cycle of m (restart = maxiter) that stops after k iterations
    (m itself where it never converges): equal to the eager control, and
    the nodes reached are the chain's."""
    mv, pc, b = _system()
    x0 = torch.zeros_like(b)
    want = gmres_device(mv, b, x0, pc, rtol, m, m, blocked=blocked,
                        ctl=EAGER)
    ctl = RecordingControl()
    got = gmres_device(mv, b, x0, pc, rtol, m, m, blocked=blocked, ctl=ctl)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert int(got[1]) == k
    [(guard, chain)] = _cycles(ctl.log)
    assert guard is None
    its = _iterations(chain)
    groups = [e for e in its if e["kind"] == "group"]
    inner = [e for e in its if e["kind"] == "iteration"]
    assert len(its) == chain_nodes(k, m, GROUP)
    assert len(groups) == -(-m // GROUP)
    assert all(e["depth"] == 0 for e in groups)
    assert all(e["depth"] == 1 for e in inner)
    assert sum(e["live"] for e in its) == k
    assert [e["live"] for e in groups] == [
        g * GROUP < k for g in range(len(groups))]
    # the chain: the first node by the compare-and-set kernel, each later
    # live one by the Givens update before it; a dead one by the Givens
    # update (the last live iteration's next) or by nothing
    assert groups[0]["set_by"] == "cond_set"
    for e in its[1:]:
        assert e["set_by"] in (("givens_column",) if e["live"] else
                               ("givens_column", None))
    dead_set = [e for e in its if not e["live"] and e["set_by"]]
    assert len(dead_set) == (1 if k < m else 0)
    passes = [e for e in chain if e["kind"] == "cmp"]
    assert len(passes) == (k if blocked else 0)
    assert all(e["set_by"] == "cond_set" for e in passes)
    assert not [e for e in ctl.log if e["kind"] == "set_if"]
    assert len(ctl.log) == chain_nodes(k, m, GROUP) + len(passes)


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("restart,maxiter,rtol", [(20, 60, 1e-4),
                                                  (10, 35, 1e-6),
                                                  (20, 60, 1e-9)])
def test_restarted_cycles_sit_under_compare_and_set_guards(blocked, restart,
                                                           maxiter, rtol):
    """Restarted solves: equal to the eager control; each cycle after the
    first under a guard (res > tol) that the compare-and-set kernel
    decides, live while the solve had not converged; each cycle's chain as
    one cycle's, one level deeper; the live iterations the solve's."""
    mv, pc, b = _system()
    x0 = torch.zeros_like(b)
    want = gmres_device(mv, b, x0, pc, rtol, restart, maxiter,
                        blocked=blocked, ctl=EAGER)
    ctl = RecordingControl()
    got = gmres_device(mv, b, x0, pc, rtol, restart, maxiter,
                       blocked=blocked, ctl=ctl)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    cycles = _cycles(ctl.log)
    assert len(cycles) == -(-maxiter // restart)
    total, ran = 0, True
    for c, (guard, chain) in enumerate(cycles):
        if c == 0:
            assert guard is None
        else:
            assert guard["set_by"] == "cond_set"
            assert guard["live"] == ran
        if not (guard is None or guard["live"]):
            assert chain == []
            ran = False
            continue
        its = _iterations(chain)
        k = sum(e["live"] for e in its)
        total += k
        assert all(e["depth"] == (c > 0) + (e["kind"] == "iteration")
                   for e in its)
        assert len(its) == chain_nodes(k, restart, GROUP)
        ran = k == restart
    assert total == int(got[1])


@pytest.mark.parametrize("flag", [0, 1, 2, 3])
def test_flag_guard_is_a_compare_and_set_node(flag):
    """A chunk step's guard, run_if_cmp(ZERO, flag): one node decided by
    the compare-and-set kernel, its body run where flag == 0, with None
    for its predicate (as inside a graph)."""
    ctl, ran = RecordingControl(), []
    ctl.run_if_cmp(ZERO, torch.tensor(flag, dtype=torch.int32), None,
                   ran.append)
    assert ran == ([None] if flag == 0 else [])
    assert ctl.log == [dict(kind="cmp", set_by="cond_set", depth=0,
                            live=flag == 0)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cond_twin_equals_the_torch_decisions(dtype):
    """hn < 0.7 * wn0, beta > tol, res > tol and flag == 0: cond_plain and
    cond_set on CPU tensors equal torch's expressions and NumPy's
    arithmetic at the dtype, on straddling values, bit for bit."""
    npdt = getattr(np, dtype)
    tdt = getattr(torch, dtype)
    pairs = straddling(np.random.default_rng(11), dtype)
    assert len(pairs) > 64
    out = torch.empty((), dtype=torch.bool)
    for a, b in pairs:
        ta, tb = torch.tensor(a, dtype=tdt), torch.tensor(b, dtype=tdt)
        with np.errstate(invalid="ignore", over="ignore"):
            np_less = bool(npdt(a) < npdt(0.7) * npdt(b))
        for op, scale, torch_form, np_form in (
                (LESS, 0.7, ta < 0.7 * tb, np_less),
                (GREATER, 1.0, ta > tb, bool(npdt(a) > npdt(b))),
                (ZERO, 1.0, ta == 0, bool(npdt(a) == 0))):
            twin = cond_plain(op, ta, tb, scale)
            assert twin.dtype == torch.bool and twin.shape == ()
            assert bool(twin) == bool(torch_form) == np_form, (op, a, b)
            assert cond_set(op, ta, tb, scale, out=out) is out
            assert bool(out) == np_form
            h = Handle()
            assert cond_set(op, ta, tb, scale, handle=h) is None
            assert bool(h.cond) == np_form and h.set_by == "cond_set"


def test_cond_twin_straddles_the_wide_product():
    """At f32 the straddling pairs hold products that decide otherwise when
    0.7 * wn0 is formed at f64 and rounded: the twin does not."""
    pairs = straddling(np.random.default_rng(11), "float32")
    differ = 0
    for a, b in pairs:
        with np.errstate(invalid="ignore", over="ignore"):
            wide = bool(np.float64(a) < 0.7 * np.float64(b))
        twin = bool(cond_plain(LESS, torch.tensor(a), torch.tensor(b), 0.7))
        differ += wide != twin
    assert differ >= 8


@pytest.mark.parametrize("flag", [0, 1, 2, 3, -1])
def test_cond_twin_int32_flags(flag):
    f = torch.tensor(flag, dtype=torch.int32)
    assert bool(cond_set(ZERO, f)) == (flag == 0)


@pytest.mark.parametrize("bad", ["op", "int_less", "mixed", "out_dtype",
                                 "shape", "no_b"])
def test_cond_set_refuses_bad_input(bad):
    a = torch.tensor(1.0)
    b = torch.tensor(2.0)
    args = dict(op=LESS, a=a, b=b)
    err = TypeError
    if bad == "op":
        args["op"], err = 7, ValueError
    elif bad == "int_less":
        args["a"] = torch.tensor(1, dtype=torch.int32)
    elif bad == "mixed":
        args["b"] = torch.tensor(2.0, dtype=torch.float64)
    elif bad == "out_dtype":
        args["out"] = torch.empty((), dtype=torch.int32)
    elif bad == "shape":
        args["a"], err = torch.ones(2), ValueError
    else:
        args["b"] = None
    with pytest.raises(err):
        cond_set(**args)


@pytest.mark.parametrize("live", [True, False])
def test_givens_twin_sets_the_next_condition_to_the_new_live(live):
    """A live call sets the next node's condition to the new live (here
    true, then false at the cycle's last column); a dead call sets none."""
    m = 4
    for j, want in ((1, True), (m - 1, False)):
        rng = np.random.default_rng(j)
        t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
        h = t(rng.standard_normal(j + 1))
        g = torch.zeros(m + 1, dtype=torch.float64)
        g[j] = 1.0
        nxt = Handle()
        givens_plain(h, t(0.5), j, torch.zeros((m + 1, m),
                                               dtype=torch.float64),
                     torch.zeros(m, dtype=torch.float64),
                     torch.zeros(m, dtype=torch.float64), g,
                     torch.zeros((), dtype=torch.float64), t(1e-12),
                     torch.tensor(live), torch.zeros((), dtype=torch.int32),
                     next_cond=nxt)
        if live:
            assert bool(nxt.cond) == want and nxt.set_by == "givens_column"
        else:
            assert nxt.cond is None and nxt.set_by is None


def test_chain_nodes_counts():
    """The count behind the I5 chain check and PERF.md: a main step of 42
    Krylov iterations of FGMRES(90) reaches 54 iteration nodes (12 groups,
    6 dead; 42 inner, 6 dead); all 90 live, 90; none live, 12."""
    assert chain_nodes(42, 90, 8) == 54
    assert chain_nodes(90, 90, 8) == 90
    assert chain_nodes(0, 90, 8) == 12
    assert chain_nodes(45, 90, 8) == 54
    assert graph_if.GROUP == GROUP == 8
