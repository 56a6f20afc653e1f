"""The plain implicit pseudo-time step: block-Jacobi sweeps, right-
preconditioned GMRES and the positivity-limited update.

    (area/(cfl dt) I + J1) du = rhs,   u' = u + omega du

with J1 the first-order Jacobian of -rhs (flow.FlowRef.jacobian), the
preconditioner `sweeps` block-Jacobi sweeps z' = D^-1 v - D^-1 N z_nbr from
z = D^-1 v, and GMRES from du = 0 run for a given number of Arnoldi
steps (the program's own count, so that both minimise the residual over
the same Krylov space), restarting every `restart` steps. omega is 1,
capped at omega_cap, then halved per cell (down to 1/32, else 0) until
density and pressure stay above 1% of their current values.
"""

from __future__ import annotations

import torch


def bsgs(D, N, nbr, sweeps: int):
    """The preconditioner v -> z of `sweeps` block-Jacobi sweeps."""
    Dinv = torch.linalg.inv(D.float() if D.dtype == torch.bfloat16
                            else D).to(D.dtype)
    DN = torch.einsum("cij,ckjl->ckil", Dinv, N)

    def pc(v):
        dv = torch.einsum("cij,cj->ci", Dinv, v)
        z = dv
        for _ in range(sweeps):
            z = dv - torch.einsum("ckij,ckj->ci", DN, z[nbr])
        return z
    return pc


def matvec(D, N, nbr):
    return lambda x: (torch.einsum("cij,cj->ci", D, x)
                      + torch.einsum("ckij,ckj->ci", N, x[nbr]))


def gmres(mv, pc, b, iters: int, restart: int):
    """x after `iters` Arnoldi steps of restarted right-preconditioned
    GMRES from 0 (classical Gram-Schmidt, twice)."""
    shape, n = b.shape, b.numel()
    x = torch.zeros(n, dtype=b.dtype, device=b.device)
    bf = b.reshape(n)
    done = 0
    while done < iters:
        m = min(restart, iters - done)
        r = bf - mv(x.reshape(shape)).reshape(n) if done else bf
        beta = torch.linalg.vector_norm(r)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        Z = torch.zeros((m, n), dtype=b.dtype, device=b.device)
        H = torch.zeros((m + 1, m), dtype=torch.float64, device=b.device)
        V[0] = r / beta
        for j in range(m):
            Z[j] = pc(V[j].reshape(shape)).reshape(n)
            w = mv(Z[j].reshape(shape)).reshape(n)
            h = V[:j + 1] @ w
            w = w - V[:j + 1].T @ h
            h2 = V[:j + 1] @ w
            w = w - V[:j + 1].T @ h2
            hn = torch.linalg.vector_norm(w)
            H[:j + 1, j] = (h + h2).double()
            H[j + 1, j] = hn.double()
            V[j + 1] = w / hn
        e1 = torch.zeros(m + 1, dtype=torch.float64, device=b.device)
        e1[0] = beta.double()
        y = torch.linalg.lstsq(H.cpu(), e1.cpu()[:, None]).solution[:, 0]
        x = x + Z.T @ y.to(device=b.device, dtype=b.dtype)
        done += m
    return x.reshape(shape)


def update_factor(gas, u, du, omega_cap: float):
    rho0, p0 = u[:, 0], gas.pressure(u)
    omega = torch.full_like(rho0, min(1.0, float(omega_cap)))
    scale = torch.zeros_like(omega)
    for om in (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125):
        ut = u + (omega * om)[:, None] * du
        ok = (ut[:, 0] > 0.01 * rho0) & (gas.pressure(ut) > 0.01 * p0)
        scale = torch.where((scale == 0.0) & ok, om, scale)
    return omega * scale


def implicit_step(flow, u, cfl, iters: int, restart: int, sweeps: int,
                  omega_cap: float = 1.0, krylov_dtype=None,
                  residual_dtype=None):
    """(u', rhs) of one implicit step from states u (nelem, 4).

    `residual_dtype` and `krylov_dtype` (default: u's) are the precisions of
    the residual and update, and of the Jacobian, preconditioner and
    Krylov solve."""
    rd = residual_dtype or u.dtype
    kd = krylov_dtype or u.dtype
    fr = flow if rd == flow.geo.area.dtype else flow.to(rd)
    ur = u.to(rd)
    rhs, dt = fr.residual(ur)
    jd = torch.float32 if kd == torch.bfloat16 else kd
    fj = fr if jd == rd else fr.to(jd)
    D, N = fj.jacobian(ur.to(jd), cfl, dt.to(jd))
    D, N = D.to(kd), N.to(kd)
    nbr = flow.geo.nbr
    du = gmres(matvec(D, N, nbr), bsgs(D, N, nbr, sweeps), rhs.to(kd),
               iters, restart).to(rd)
    return ur + update_factor(fr.gas, ur, du, omega_cap)[:, None] * du, rhs
