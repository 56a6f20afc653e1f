"""The banded block apply and the fused bsgs apply as hand-written CUDA
kernels for Hopper.

Replace the TPU kernel `_banded_apply` (body `_apply_kernel`) in the JAX
package's solver/pallas_banded.py, and its two operator builders
`make_banded_matvec_pallas` / `make_banded_bsgs_pallas`, with the same
signatures. Two kernels share one cell's arithmetic (csrc/banded_block.cuh):

  - csrc/banded_apply.cu, one launch per apply,

        out[c] = base[c] + sign * sum_k B_k[:, :, c] . x[(c + d_k) mod NC]

    one thread per cell, with the band blocks in banded_blocks' (K, V, V, NC)
    cell-minor layout and the vectors in the solver's (NC, V) layout. It is
    the matvec (the diagonal joins as the d = 0 band). No wrap-padded copy
    of x (a non-negative modulo finds the shifted row), no transposes, no
    tile-size gate: any NC, f32 and f64, fully band-covered meshes only;
  - csrc/banded_bsgs.cu, the whole bsgs preconditioner apply (D^-1 v, then
    `sweeps` damped block-Jacobi sweeps) in ONE persistent cooperative
    launch that keeps as much of D^-1 N in shared memory across the sweeps
    as the card allows (bsgs_launch_plan) and skips each band outside the
    cells where it is nonzero (BandedStructure.support). It equals the
    seven-launch sequence of banded_apply (make_banded_bsgs_sequence) value
    for value: the same products summed in the same order, less the
    skipped zero products.

Both take V x V blocks for V in BLOCK_SIZES: 4 (the flow equations) and
1 (the scalar diffusion), each its own instantiation of the kernels, picked
by the operands' V (`bands.shape[1]`); any other V raises ValueError.

`banded_apply` and `bsgs_apply` launch their kernel for CUDA tensors and
raise if the launch fails; for CPU tensors they take their plain PyTorch
twins (`banded_apply_plain`, `bsgs_apply_plain`). `banded_apply.launches`
and `bsgs_apply.launches` count kernel launches. The operator builders
check the operands, look up the function and build the launch arguments
once per Newton step, so that a call is one ctypes call and a torch.empty.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from .._build import CSRC_DIR, build_cuda_library
from .banded import (_block_mv, _norm_offsets, _shift, bsgs_sweeps,
                     rest_apply)

BLOCK_SIZES = (1, 4)       # the V x V blocks the kernels are built for
MAX_BANDS = 8              # the kernels' offset table size
DTYPES = (torch.float32, torch.float64)

_LIBS = {}                 # source name: (ctypes.CDLL, BuildInfo)
_LIMITS = {}               # device index: the bsgs kernel's device limits
_WAITS = {}                # (device, NC, chunk, blocks, shifts, support):
                           # the bsgs kernel's waits and their device table


class BsgsArgs(ctypes.Structure):
    """The fused kernel's launch arguments; mirrors `BsgsArgs` in
    csrc/banded_bsgs.cu."""
    _fields_ = [("dinv", ctypes.c_void_p), ("dn", ctypes.c_void_p),
                ("dv", ctypes.c_void_p), ("z", ctypes.c_void_p),
                ("flags", ctypes.c_void_p), ("waits", ctypes.c_void_p),
                ("device", ctypes.c_int), ("nc", ctypes.c_int),
                ("ld", ctypes.c_int), ("nbands", ctypes.c_int),
                ("sweeps", ctypes.c_int), ("blocks", ctypes.c_int),
                ("chunk", ctypes.c_int), ("n_res", ctypes.c_int),
                ("smem_bytes", ctypes.c_int), ("dense", ctypes.c_int),
                ("offsets", ctypes.c_int * MAX_BANDS),
                ("lo", ctypes.c_int * MAX_BANDS),
                ("hi", ctypes.c_int * MAX_BANDS)]


def _entry(lib, stem: str, V: int, dtype):
    """The C entry point of `stem` for V x V blocks and dtype, e.g.
    fvens_banded_apply_f32 (V = 4) or fvens_banded_apply_v1_f64."""
    return getattr(lib, f"{stem}{'_v1' if V == 1 else ''}_"
                        f"{'f32' if dtype == torch.float32 else 'f64'}")


def _load(name: str):
    """Build (at first use) and load csrc/<name>.cu; returns the CDLL."""
    if name not in _LIBS:
        lib, info = build_cuda_library(
            name, [os.path.join(CSRC_DIR, f"{name}.cu")])
        if name == "banded_apply":
            for fn in (_entry(lib, "fvens_banded_apply", V, dt)
                       for V in BLOCK_SIZES for dt in DTYPES):
                fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p, ctypes.c_double,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.fvens_cuda_error_string.argtypes = [ctypes.c_int]
            lib.fvens_cuda_error_string.restype = ctypes.c_char_p
        else:
            for fn in (_entry(lib, "fvens_banded_bsgs", V, dt)
                       for V in BLOCK_SIZES for dt in DTYPES):
                fn.argtypes = [ctypes.POINTER(BsgsArgs), ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.fvens_bsgs_device_limits.argtypes = [ctypes.c_int,
                                                     ctypes.c_void_p]
            lib.fvens_bsgs_device_limits.restype = ctypes.c_int
            lib.fvens_bsgs_error_string.argtypes = [ctypes.c_int]
            lib.fvens_bsgs_error_string.restype = ctypes.c_char_p
        _LIBS[name] = (lib, info)
    return _LIBS[name][0]


def load_library():
    """Build (at first use) and load csrc/banded_apply.cu. Returns the
    BuildInfo (library path, nvcc seconds, ptxas log)."""
    _load("banded_apply")
    return _LIBS["banded_apply"][1]


def load_bsgs_library():
    """Build (at first use) and load csrc/banded_bsgs.cu. Returns the
    BuildInfo."""
    _load("banded_bsgs")
    return _LIBS["banded_bsgs"][1]


def _raise_launch(what: str, lib, errfn: str, err: int):
    msg = getattr(lib, errfn)(err).decode()
    raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {err})")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check_ops(what: str, tensors, dtype, device):
    if dtype not in DTYPES:
        raise TypeError(f"{what} takes float32/float64, got {dtype}")
    if any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{what}: operands must share one dtype")
    if any(t.device != device for t in tensors):
        raise ValueError(f"{what}: operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {device}")


def _check_bands(bands, dms):
    """Checks bands (K, V, V, NC) and its K shifts; returns V."""
    if bands.dim() != 4 or bands.shape[1] != bands.shape[2]:
        raise ValueError(f"bands must be (K, V, V, NC), got "
                         f"{tuple(bands.shape)}")
    V = bands.shape[1]
    if V not in BLOCK_SIZES:
        sizes = " or ".join(f"{b}x{b}" for b in BLOCK_SIZES)
        raise ValueError(f"the banded kernels take {sizes} blocks, got "
                         f"{V}x{V}")
    K = bands.shape[0]
    if not 1 <= K <= MAX_BANDS or len(dms) != K:
        raise ValueError(f"need 1 <= K <= {MAX_BANDS} bands and one shift "
                         f"each, got K={K}, {len(dms)} shifts")
    return V


def _check_vec(name, t, NC, V):
    if tuple(t.shape) != (NC, V):
        raise ValueError(f"{name} must be ({NC}, {V}), got {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# banded_apply: one launch per apply
# ---------------------------------------------------------------------------

def banded_apply_plain(bands, x, dms, sign=1.0, base=None):
    """Plain PyTorch twin of the kernel: bands (K, V, V, NC), x (NC, V),
    dms K shifts, base (NC, V) or None. Returns a contiguous (NC, V)."""
    xt = x.T
    acc = None
    for k, d in enumerate(dms):
        t = _block_mv(bands[k], _shift(xt, d))
        acc = t if acc is None else acc + t
    y = sign * acc.T
    if base is not None:
        y = base + y
    return y.contiguous()


class BandedApply:
    """out = base + sign * sum_k B_k x_(+d_k) with bands and shifts fixed:
    the operands are checked and the launch arguments built once; a call
    checks x (and base) and launches, or on CPU tensors runs the twin."""

    def __init__(self, bands, dms, sign=1.0):
        self.V = _check_bands(bands, dms)
        _check_ops("banded_apply", [bands], bands.dtype, bands.device)
        self.bands, self.dms, self.sign = bands, tuple(dms), float(sign)
        self.NC, self.dtype, self.device = (bands.shape[3], bands.dtype,
                                            bands.device)
        if self.device.type == "cuda":
            self._fn = _entry(_load("banded_apply"), "fvens_banded_apply",
                              self.V, self.dtype)
            self._offs = (ctypes.c_int * MAX_BANDS)(*self.dms)
            self._offs_ptr = ctypes.addressof(self._offs)

    def __call__(self, x, base=None):
        _check_vec("x", x, self.NC, self.V)
        ops = [x] if base is None else [x, base]
        if base is not None:
            _check_vec("base", base, self.NC, self.V)
        _check_ops("banded_apply", ops, self.dtype, self.device)
        if self.device.type == "cpu":
            return banded_apply_plain(self.bands, x, self.dms, self.sign, base)
        out = torch.empty_like(x)
        err = self._fn(self.device.index, self.bands.data_ptr(), x.data_ptr(),
                       None if base is None else base.data_ptr(),
                       out.data_ptr(), self.NC, len(self.dms), self._offs_ptr,
                       self.sign, _stream(self.device))
        if err != 0:
            _raise_launch("banded_apply", _LIBS["banded_apply"][0],
                          "fvens_cuda_error_string", err)
        banded_apply.launches += 1
        return out


def banded_apply(bands, x, dms, sign=1.0, base=None):
    """out = base + sign * sum_k B_k x_(+d_k): the CUDA kernel on a CUDA
    tensor, its plain twin on a CPU tensor. Returns a new (NC, V) tensor."""
    if x.dtype != bands.dtype:
        raise TypeError("bands, x and base must share one dtype")
    return BandedApply(bands, dms, sign)(x, base)


banded_apply.launches = 0


# ---------------------------------------------------------------------------
# bsgs_apply: the whole preconditioner apply in one launch
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BsgsPlan:
    """How the fused kernel splits NC cells: block b owns cells
    [b * chunk, min((b + 1) * chunk, NC)); the first n_res of them keep
    their dense bands and base in smem_bytes of shared memory, the rest
    read them from device memory (L2 after the first sweep)."""
    blocks: int
    chunk: int
    n_res: int
    smem_bytes: int


BSGS_HEADER_BYTES = 16     # the kernel's dynamic shared memory before the
                           # planes (its mbarrier)
# What the plan leaves of an SM's shared memory and L1 (one 256 KB array on
# Hopper) to L1, for the sweeps' gathers of z rows: with 32 KB left the card
# takes its 196 KB shared-memory configuration (60 KB of L1) in place of the
# 228 KB one (28 KB): the apply at 640x320 took 78.3 us in place of 83.9 at
# f32, 261.5 in place of 282.2 at f64, on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md).
BSGS_L1_BYTES = 32 * 1024


def bsgs_cell_bytes(K: int, dtype, V: int = 4) -> int:
    """Shared memory one resident cell takes: the V * V entries of each of
    the K bands kept there, and its V entries of D^-1 v."""
    return (K * V * V + V) * _itemsize(dtype)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def bsgs_align(dtype) -> int:
    """Cells in 16 bytes: the TMA copies' granule, to which the plan rounds
    block starts, the shared tier and the bands' plane stride."""
    return 16 // _itemsize(dtype)


def bsgs_dense_bands(support, NC: int) -> tuple:
    """Which bands the fused kernel keeps in shared memory: those whose
    support spans more than half of the cells (on the O-meshes all but the
    two seam bands, which hold one ring of cells each)."""
    return tuple(2 * (hi - lo) > NC for lo, hi in support)


def bsgs_bands_fit_l2(support, dense, dtype, l2_bytes: int,
                      V: int = 4) -> bool:
    """Whether the dense bands (V x V blocks), over their supports, fit in
    half of the card's L2: then they stay in L2 from sweep to sweep by
    themselves, and the fused kernel keeps none in shared memory (at the
    12,800-cell bench mesh bringing them in cost more than it saved;
    PERF.md)."""
    cells = sum(hi - lo for (lo, hi), d in zip(support, dense) if d)
    return 2 * cells * V * V * _itemsize(dtype) <= l2_bytes


def bsgs_launch_plan(NC: int, K: int, dtype, smem_bytes: int,
                     n_blocks: int, V: int = 4) -> BsgsPlan:
    """The fused kernel's grid for NC cells with K bands of V x V blocks
    kept in shared memory: at most n_blocks blocks (one per SM) of equal
    cell ranges, each a whole number of 16-byte runs, each keeping as many
    of its cells resident, in whole 16-byte runs, as smem_bytes of shared
    memory hold after the kernel's header."""
    if NC < 1 or not 0 <= K <= MAX_BANDS or n_blocks < 1 or smem_bytes < 0:
        raise ValueError(f"no plan for NC={NC}, K={K}, n_blocks={n_blocks}, "
                         f"smem_bytes={smem_bytes}")
    a = bsgs_align(dtype)
    chunk = -(-NC // n_blocks)
    chunk = -(-chunk // a) * a
    per_cell = bsgs_cell_bytes(K, dtype, V)
    room = max(0, smem_bytes - BSGS_HEADER_BYTES) // per_cell
    n_res = min(chunk, room) // a * a
    return BsgsPlan(blocks=-(-NC // chunk), chunk=chunk, n_res=n_res,
                    smem_bytes=(BSGS_HEADER_BYTES + n_res * per_cell
                                if n_res else 0))


def bsgs_block_deps(NC: int, chunk: int, blocks: int, dms, support) -> tuple:
    """deps(b) for each block b: the other blocks that own a cell
    (c + d_k) mod NC for some cell c of block b inside band k's support,
    i.e. whose z a sweep of block b reads."""
    deps = []
    for b in range(blocks):
        c0, c1 = b * chunk, min((b + 1) * chunk, NC)
        owners = set()
        for d, (lo, hi) in zip(dms, support):
            a, e = max(c0, lo), min(c1, hi)
            if a >= e:
                continue
            s, n = (a + d) % NC, e - a          # n <= chunk <= NC: one wrap
            for x, y in ((s, min(s + n, NC)), (0, s + n - NC)):
                if x < y:
                    owners.update(range(x // chunk, (y - 1) // chunk + 1))
        owners.discard(b)
        deps.append(tuple(sorted(owners)))
    return tuple(deps)


def bsgs_block_waits(deps) -> tuple:
    """waits(b) = deps(b) + {b' : b in deps(b')}: the blocks whose previous
    phase block b waits for before each phase. deps orders the z it reads
    after their writes; the reverse set orders its writes, which overwrite
    the buffer of two phases back, after every read of them."""
    waits = [set(d) for d in deps]
    for b, d in enumerate(deps):
        for o in d:
            waits[o].add(b)
    return tuple(tuple(sorted(w)) for w in waits)


def _waits_table(waits) -> list:
    """waits as the kernel reads it: blocks + 1 offsets into the same list,
    then each block's waits."""
    offsets, flat = [], []
    start = len(waits) + 1
    for w in waits:
        offsets.append(start + len(flat))
        flat.extend(w)
    return offsets + [start + len(flat)] + flat


def _block_waits(device, NC: int, plan: BsgsPlan, dms, support):
    """(waits, the kernel's table of them on `device`), computed once per
    mesh and plan: the operator is rebuilt every Newton step, its waits
    are not."""
    key = (device, NC, plan.chunk, plan.blocks, dms, support)
    if key not in _WAITS:
        waits = bsgs_block_waits(bsgs_block_deps(
            NC, plan.chunk, plan.blocks, dms, support))
        _WAITS[key] = (waits, torch.tensor(_waits_table(waits),
                                           dtype=torch.int32, device=device))
    return _WAITS[key]


def bsgs_device_limits(device) -> dict:
    """SMs, shared memory per block and per SM, the L2 cache's size, the
    fused kernel's threads per block, and the plan's default grid and
    shared memory per block, read from the card once."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _LIMITS:
        lib = _load("banded_bsgs")
        out = (ctypes.c_int * 7)()
        err = lib.fvens_bsgs_device_limits(idx, ctypes.addressof(out))
        if err != 0:
            _raise_launch("banded_bsgs", lib, "fvens_bsgs_error_string", err)
        lim = dict(zip(("sms", "smem_optin", "smem_per_sm", "smem_reserved",
                        "l2_bytes", "threads", "header_bytes"), out))
        if lim["header_bytes"] != BSGS_HEADER_BYTES:
            raise RuntimeError("banded_bsgs.cu and banded_kernels.py differ "
                               f"on the kernel's layout: {lim}")
        # the plan's defaults: one block on every SM, with the SM's shared
        # memory less BSGS_L1_BYTES
        lim["n_blocks"] = lim["sms"]
        lim["smem_per_block"] = min(
            lim["smem_optin"],
            lim["smem_per_sm"] - lim["smem_reserved"] - BSGS_L1_BYTES)
        _LIMITS[idx] = lim
    return _LIMITS[idx]


def bsgs_apply_plain(dinv, dn, dms, sweeps, v):
    """Plain PyTorch twin of the fused kernel: banded.make_banded_bsgs's
    arithmetic on dinv (1, V, V, NC), dn (K, V, V, NC), v (NC, V)."""
    return bsgs_sweeps(dinv[0], dn, dms, sweeps, v).contiguous()


def _check_bsgs(dinv, dn, dms, sweeps, support):
    """Checks the fused apply's operands; returns V."""
    V = _check_bands(dn, dms)
    NC = dn.shape[3]
    if support is not None and (
            len(support) != len(dms)
            or not all(0 <= lo <= hi <= NC for lo, hi in support)):
        raise ValueError(f"support must be {len(dms)} (lo, hi) cell ranges "
                         f"within [0, {NC}], got {support!r}")
    if tuple(dinv.shape) != (1, V, V, NC):
        raise ValueError(f"dinv must be (1, {V}, {V}, {NC}), got "
                         f"{tuple(dinv.shape)}")
    if not isinstance(sweeps, int) or sweeps < 0:
        raise ValueError(f"sweeps must be an int >= 0, got {sweeps!r}")
    _check_ops("bsgs_apply", [dinv, dn], dn.dtype, dn.device)
    return V


class BsgsApply:
    """The bsgs apply with D^-1, D^-1 N, shifts and sweeps fixed: operands
    checked, launch planned, block waits looked up and scratch and flags
    allocated once; a call checks v and makes one launch (on CPU tensors:
    the twin). The scratch and the flags are shared by the calls, so the
    calls of one operator must be ordered by one stream (the solver's: the
    current stream), as they are. The flags count the phases done on the
    card and are never reset, so a call captured in a CUDA graph stays
    right at every replay.

    support: per band the (lo, hi) cell range outside which its blocks are
    zero (BandedStructure.support; default: all cells); the kernel skips a
    band outside it, and keeps only the bands that span most cells
    (bsgs_dense_bands) on chip, and none where they fit in L2
    (bsgs_bands_fit_l2). smem_bytes and n_blocks override the shared
    memory per block and the grid in the plan (tests force the residency
    cases with them)."""

    def __init__(self, dinv, dn, dms, sweeps: int, support=None,
                 smem_bytes=None, n_blocks=None):
        self.V = V = _check_bsgs(dinv, dn, dms, sweeps, support)
        self.dinv, self.dn, self.dms, self.sweeps = dinv, dn, tuple(dms), \
            sweeps
        self.NC, self.dtype, self.device = dn.shape[3], dn.dtype, dn.device
        if self.device.type != "cuda":
            return
        self.support = (tuple((0, self.NC) for _ in self.dms)
                        if support is None else
                        tuple((int(lo), int(hi)) for lo, hi in support))
        dense = bsgs_dense_bands(self.support, self.NC)
        lim = bsgs_device_limits(self.device)
        if smem_bytes is None:
            smem_bytes = (0 if bsgs_bands_fit_l2(self.support, dense,
                                                 self.dtype, lim["l2_bytes"],
                                                 V)
                          else lim["smem_per_block"])
        self.plan = p = bsgs_launch_plan(
            self.NC, sum(dense), self.dtype, smem_bytes,
            lim["n_blocks"] if n_blocks is None else n_blocks, V)
        self.waits, self._waits = _block_waits(self.device, self.NC, p,
                                               self.dms, self.support)
        # one thread spins on each
        assert max(map(len, self.waits)) <= lim["threads"]
        # the bands' planes 16-byte aligned for the TMA copies: a padded
        # copy where NC or the tensor's address is not
        a = bsgs_align(self.dtype)
        ld = -(-self.NC // a) * a
        self._dn = dn
        if ld != self.NC or dn.data_ptr() % 16:
            self._dn = torch.zeros(dn.shape[:3] + (ld,), dtype=self.dtype,
                                   device=self.device)
            self._dn[..., :self.NC] = dn
        self._fn = _entry(_load("banded_bsgs"), "fvens_banded_bsgs", V,
                          self.dtype)
        # dv and z, each 16-byte aligned (at V = 1 a buffer of NC values
        # is not a whole number of 16 bytes: the second starts at ld)
        self._scratch = torch.empty((2, ld, V), dtype=self.dtype,
                                    device=self.device)
        self._flags = torch.zeros(p.blocks, dtype=torch.int64,
                                  device=self.device)
        self._args = BsgsArgs(
            dinv=dinv.data_ptr(), dn=self._dn.data_ptr(),
            dv=self._scratch[0].data_ptr(), z=self._scratch[1].data_ptr(),
            flags=self._flags.data_ptr(), waits=self._waits.data_ptr(),
            device=self.device.index, nc=self.NC, ld=ld,
            nbands=len(self.dms), sweeps=sweeps, blocks=p.blocks,
            chunk=p.chunk, n_res=p.n_res,
            smem_bytes=p.smem_bytes,
            dense=sum(1 << k for k, d in enumerate(dense) if d),
            offsets=(ctypes.c_int * MAX_BANDS)(*self.dms),
            lo=(ctypes.c_int * MAX_BANDS)(*(lo for lo, _ in self.support)),
            hi=(ctypes.c_int * MAX_BANDS)(*(hi for _, hi in self.support)))
        self._args_ref = ctypes.byref(self._args)

    def __call__(self, v):
        _check_vec("v", v, self.NC, self.V)
        _check_ops("bsgs_apply", [v], self.dtype, self.device)
        if self.device.type == "cpu":
            return bsgs_apply_plain(self.dinv, self.dn, self.dms, self.sweeps,
                                    v)
        out = torch.empty_like(v)
        err = self._fn(self._args_ref, v.data_ptr(), out.data_ptr(),
                       _stream(self.device))
        if err != 0:
            _raise_launch("banded_bsgs", _LIBS["banded_bsgs"][0],
                          "fvens_bsgs_error_string", err)
        bsgs_apply.launches += 1
        return out


def bsgs_apply(dinv, dn, dms, sweeps: int, v, support=None,
               smem_bytes=None, n_blocks=None):
    """The bsgs preconditioner apply z = D^-1 v, then `sweeps` times
    z <- D^-1 v - sum_k (D^-1 N)_k z_(+d_k): one launch of the fused CUDA
    kernel on CUDA tensors, its plain twin on CPU tensors. dinv (1, V, V,
    NC) and dn (K, V, V, NC) as bsgs_bands gives them, v (NC, V); support
    as BsgsApply takes it."""
    if v.dtype != dn.dtype:
        raise TypeError("dinv, dn and v must share one dtype")
    return BsgsApply(dinv, dn, dms, sweeps, support, smem_bytes,
                     n_blocks)(v)


bsgs_apply.launches = 0


# ---------------------------------------------------------------------------
# operator builders (once per Newton step)
# ---------------------------------------------------------------------------

def matvec_bands(D, Bt, offsets):
    """(bands, shifts) of the matvec launch: D (NC, V, V) joins the band
    blocks Bt (K, V, V, NC) as the d = 0 band, so K + 1 bands."""
    dms = (0,) + _norm_offsets(offsets, D.shape[0])
    return torch.cat([D.permute(1, 2, 0)[None], Bt]).contiguous(), dms


def bsgs_bands(Dinv, DNbt, offsets):
    """((bands, shifts) of the D^-1 v launch, (bands, shifts) of a sweep)."""
    dinv = Dinv.permute(1, 2, 0)[None].contiguous()           # (1, V, V, NC)
    return ((dinv, (0,)),
            (DNbt.contiguous(), _norm_offsets(offsets, Dinv.shape[0])))


def make_banded_matvec_kernel(D, Bt, offsets, bl=None, R=None):
    """Kernel form of banded.make_banded_matvec: the diagonal D joins as the
    d = 0 band, so the bands are one launch; with K = MAX_BANDS bands (the
    most a part of a partitioned mesh takes) the diagonal is a launch of
    its own, the base of the bands' launch. A part's rest list
    (R = banded.rest_blocks(bl, N)) is added after it in PyTorch.
    D (NC, V, V); Bt (K, V, V, NC) from banded_blocks."""
    if len(offsets) < MAX_BANDS:
        first, apply = None, BandedApply(*matvec_bands(D, Bt, offsets))
    else:
        first = BandedApply(D.permute(1, 2, 0)[None].contiguous(), (0,))
        apply = BandedApply(Bt.contiguous(), _norm_offsets(offsets,
                                                           D.shape[0]))

    def mv(x):
        x = x.contiguous()
        y = apply(x) if first is None else apply(x, first(x))
        return y if R is None else rest_apply(bl, R, x, y)
    return mv


def make_banded_bsgs_kernel(Dinv, DNbt, offsets, sweeps: int, support=None):
    """Kernel form of banded.make_banded_bsgs: the whole apply (D^-1 v and
    the damped block-Jacobi sweeps) is one launch of the fused kernel.
    support: the bands' BandedStructure.support, or None (all cells)."""
    (dinv, _), (dn, dms) = bsgs_bands(Dinv, DNbt, offsets)
    apply = BsgsApply(dinv, dn, dms, sweeps, support)

    def pc(v):
        return apply(v.contiguous())
    return pc


def make_banded_bsgs_sequence(Dinv, DNbt, offsets, sweeps: int, bl=None,
                              DNr=None):
    """The bsgs apply as 1 + sweeps banded_apply launches: D^-1 v is the
    d = 0-only launch; each sweep z' = D^-1 v - (D^-1 N) z_nbr is one launch
    with base = D^-1 v and sign = -1. The fused kernel's bit-for-bit
    reference, and the solver's bsgs apply on a part with a rest list
    (DNr = banded.rest_dn_blocks(bl, Dinv, N)), whose blocks times the
    previous iterate are subtracted after each sweep's launch."""
    (dinv, _), (dn, dms) = bsgs_bands(Dinv, DNbt, offsets)
    rest = (None if DNr is None
            else lambda z, acc: rest_apply(bl, DNr, z, acc, sign=-1.0))
    return bsgs_sequence(dinv, dn, dms, sweeps, rest)


def bsgs_sequence(dinv, dn, dms, sweeps: int, rest=None):
    """make_banded_bsgs_sequence on the bands as BsgsApply takes them:
    dinv (1, V, V, NC), dn (K, V, V, NC) and its shifts dms; `rest(z, acc)`
    as in banded.bsgs_sweeps."""
    first, sweep = BandedApply(dinv, (0,)), BandedApply(dn, dms, sign=-1.0)

    def pc(v):
        dv = first(v.contiguous())
        z = dv
        for _ in range(sweeps):
            zn = sweep(z, dv)
            z = zn if rest is None else rest(z, zn)
        return z
    return pc
