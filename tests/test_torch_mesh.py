"""The port's host mesh pipeline against the JAX package's.

The NumPy modules (reader, topology, geometry, meshgen) are copies and must
give identical outputs; the port's CompiledMesh must hold every field of the
JAX package's, equal element for element (floats at f64, indices widened to
int64). The port must import with JAX unavailable.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvens_tpu.mesh import compile_mesh as jax_compile_mesh
from fvens_tpu.mesh import geometry as jgeom
from fvens_tpu.mesh import meshgen as jgen
from fvens_tpu.mesh import topology as jtopo
from fvens_tpu_torch import interop
from fvens_tpu_torch.config import BCSpec
from fvens_tpu_torch.mesh import compile_mesh
from fvens_tpu_torch.mesh import geometry as tgeom
from fvens_tpu_torch.mesh import meshgen as tgen
from fvens_tpu_torch.mesh import topology as ttopo
from fvens_tpu_torch.mesh.device_mesh import (INDEX_FIELDS, META_FIELDS,
                                              tensor_fields)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NACA_BCS = [BCSpec(marker=2, type="adiabaticwall", values=(0.0,)),
            BCSpec(marker=4, type="inflowoutflow")]
CYL_BCS = [BCSpec(marker=2, type="slipwall"),
           BCSpec(marker=4, type="farfield")]

MESHES = {
    "naca0012_omesh(64,16)": (lambda g: g.naca0012_omesh(64, 16), NACA_BCS),
    "cylinder_omesh(24,10)": (lambda g: g.cylinder_omesh(24, 10), CYL_BCS),
    "unit_square(6,tri)": (lambda g: g.unit_square(6, tri=True),
                           [BCSpec(marker=1, type="slipwall")]),
    "flatplate(0)": (lambda g: g.flatplate(0),
                     [BCSpec(marker=2, type="adiabaticwall", values=(0.0,)),
                      BCSpec(marker=3, type="slipwall"),
                      BCSpec(marker=4, type="farfield"),
                      BCSpec(marker=5, type="extrapolation")]),
}


def _equal_dataclass(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", list(MESHES))
def test_host_mesh_modules_identical(name):
    make, _ = MESHES[name]
    mdj, mdt = make(jgen), make(tgen)
    _equal_dataclass(mdj, mdt)
    tj, tt = jtopo.build_topology(mdj), ttopo.build_topology(mdt)
    _equal_dataclass(tj, tt)
    _equal_dataclass(jgeom.compute_geometry(mdj, tj),
                     tgeom.compute_geometry(mdt, tt))


@pytest.mark.parametrize("name", list(MESHES))
def test_compiled_mesh_fields_equal(name):
    make, bcs = MESHES[name]
    md = make(tgen)
    jm = jax_compile_mesh(make(jgen), bcs, dtype=jnp.float64)
    tm = compile_mesh(md, bcs, dtype=torch.float64, device="cpu")
    for f in tensor_fields():
        a, t = np.asarray(getattr(jm, f)), getattr(tm, f)
        want = torch.int64 if f in INDEX_FIELDS else torch.float64
        assert t.dtype == want, f
        assert t.shape == a.shape, f
        assert np.array_equal(t.numpy(), a), f
    for f in META_FIELDS:
        assert getattr(tm, f) == getattr(jm, f), f


def test_mesh_from_numpy_and_cast():
    md = tgen.naca0012_omesh(64, 16)
    jm = jax_compile_mesh(jgen.naca0012_omesh(64, 16), NACA_BCS,
                          dtype=jnp.float64)
    fields = {f: np.asarray(getattr(jm, f)) for f in tensor_fields()}
    fields.update({f: getattr(jm, f) for f in META_FIELDS})
    a = interop.mesh_from_numpy(fields, device="cpu")
    b = compile_mesh(md, NACA_BCS, device="cpu")
    for f in tensor_fields():
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    m32 = b.to(torch.float32)
    assert m32.dtype == torch.float32 and m32.area.dtype == torch.float32
    assert m32.cell_nbrs.dtype == torch.int64        # indices never cast
    assert m32.NC == b.NC and m32.n_bfaces == b.n_bfaces


def test_port_imports_without_jax():
    """Block jax in a fresh interpreter: every port module must import, and
    nothing of the JAX package may be pulled in."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import fvens_tpu_torch\n"
        "import fvens_tpu_torch.interop, fvens_tpu_torch.cases.bench_case\n"
        "import fvens_tpu_torch.solver.banded_kernels\n"
        "import fvens_tpu_torch.solver.steady\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and (m.split('.')[0] in ('fvens_tpu', 'jax'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
