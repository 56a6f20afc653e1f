"""The plain reference against the program on the CPU, at 32x16: meshes,
the second-order residual and time steps, the first-order Jacobian, one
implicit step, the functionals; and the controls at lower precision,
which these numbers must separate from sound runs.

Only these tests import both the reference and the program.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness, judge
from benchmark.reference import mesh as rmesh
from benchmark.tests.conftest import tiny_cell
from fvens_tpu_torch.cases.casesolvers import (SteadyFlowCase, build_space,
                                               initial_state)
from fvens_tpu_torch.mesh import meshgen
from fvens_tpu_torch.mesh.device_mesh import compile_mesh
from fvens_tpu_torch.output import make_functionals

CASES = {"cyl640-solve": 5 * 0.5625, "naca640-cli-steps": -1.25}


def test_meshes_equal_the_programs_generators():
    pairs = [(rmesh.cylinder_omesh(32, 16, 1.15 ** (20 / 16)),
              meshgen.cylinder_omesh(32, 16, stretch=1.15 ** (20 / 16))),
             (rmesh.naca0012_omesh(32, 16), meshgen.naca0012_omesh(32, 16))]
    for mine, prog in pairs:
        assert np.array_equal(mine.coords, prog.coords)
        assert np.array_equal(mine.cells, prog.inpoel)
        assert np.array_equal(np.column_stack([mine.bfaces, mine.btags]),
                              prog.bface)


@pytest.fixture(scope="module", params=sorted(CASES))
def stepped(request):
    """A cell's case at 32x16 after its starter and 4 main steps, with the
    fifth step recorded: (cell, flow ref, program space, mesh, u, step)."""
    name = request.param
    cell = tiny_cell(name)
    cell.config["mesh"].update(nt=32, nr=16)
    aoa = CASES[name]
    fc = harness.flow_config(cell.config, cell.bench_dir + "/configs", aoa)
    raw = rmesh.make_mesh(cell.config["mesh"])
    mesh = compile_mesh(harness.mesh_data(raw), fc.bcs, dtype=torch.float64,
                        device="cpu")
    space = build_space(fc)
    case = SteadyFlowCase(fc)
    u = case.execute_starter(mesh, initial_state(space, mesh))
    solver = case._make_solver(space, fc.main, checkpoint=True)
    u = solver.solve(mesh, u, max_steps=4)[0]
    rec = harness.StepRecorder(solver)
    rec.take = lambda i: True
    u5 = solver.solve(mesh, u, max_steps=1)[0]
    step = rec.kept[-1]
    assert torch.equal(step["unew"], u5)
    flow = harness.plain_flow(cell.config, raw, aoa, "cpu")
    return cell, flow, space, mesh, u, step


def test_residual_and_time_steps(stepped):
    _, flow, space, mesh, u, _ = stepped
    n = flow.geo.nelem
    rhs_p, dt_p = space.compute_residual(mesh, u, True)
    rhs_r, dt_r = flow.residual(u[:n])
    assert float((rhs_p[:n] - rhs_r).abs().max()
                 / rhs_r.abs().max()) < 1e-11
    assert float(((dt_p[:n] - dt_r) / dt_r).abs().max()) < 1e-13


def test_first_order_jacobian(stepped):
    _, flow, space, mesh, u, _ = stepped
    n = flow.geo.nelem
    jac = space.assemble_jacobian(mesh, u)
    _, dt = flow.residual(u[:n])
    D, N = flow.jacobian(u[:n], float("inf"), dt)
    scale = float(D.abs().max())
    assert float((jac.D[:n] - D).abs().max()) < 1e-13 * scale
    assert float((jac.N[:n] - N).abs().max()) < 1e-13 * scale


def test_step_and_its_control(stepped):
    cell, flow, _, _, _, step = stepped
    plain, n = cell.config["plain"], flow.geo.nelem
    sound = judge.step_gaps(flow, [step], n, plain)
    low = judge.step_gaps(flow, [step], n, plain, lower_precision=True)
    limits = cell.workload["limits"]
    for k in ("res_gap", "step_gap"):
        assert sound[k] < limits[k] < low[k], (k, sound[k], low[k])


def test_functionals(stepped):
    _, flow, space, mesh, u, _ = stepped
    n = flow.geo.nelem
    prog = [float(x) for x in make_functionals(space, (2,))(mesh, u)]
    gap = judge.functional_gap(flow, u[:n], (prog[0], prog[1], prog[2]))
    assert gap < 1e-13
