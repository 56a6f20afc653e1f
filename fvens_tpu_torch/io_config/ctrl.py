"""Reader for the reference's INFO-format .ctrl control files.

Parses the Boost property-tree INFO syntax used by FVENS control files
(doc/example-control-file.ctrl, parsed by src/utilities/controlparser.cpp:
60-300) into a FlowCaseConfig, so reference test cases run unchanged.

The files are line-oriented in practice: each line is one of
  key { | } | key value... | key
with ';'/'#' comments and optional quotes around values.
"""

from __future__ import annotations

from ..config import (BCSpec, FlowCaseConfig, LinearSolverConfig,
                      NonlinearUpdateConfig, NumericsConfig, PhysicsConfig,
                      PseudoTimeConfig)


def _parse_info(text: str) -> dict:
    """Tolerant INFO parser handling '{' on the same or following line."""
    # normalize: put '{' tokens onto their own logical records
    records = []
    for raw in text.splitlines():
        line = raw
        for mark in (";", "#"):
            idx = line.find(mark)
            if idx >= 0:
                line = line[:idx]
        line = line.strip()
        if line:
            records.append(line)

    root: dict = {}
    stack = [root]
    pending_key = None
    for line in records:
        while line:
            line = line.strip()
            if not line:
                break
            if line[0] == "{":
                child: dict = {}
                stack[-1][pending_key] = child
                stack.append(child)
                pending_key = None
                line = line[1:]
                continue
            if line[0] == "}":
                stack.pop()
                line = line[1:]
                continue
            # key [values...] [ { ]
            opener = line.endswith("{")
            if opener:
                line = line[:-1].strip()
            parts = line.split()
            key = parts[0].strip('"')
            vals = [p.strip('"') for p in parts[1:]]
            if opener:
                child = {}
                stack[-1][key] = child
                stack.append(child)
            elif vals:
                stack[-1][key] = vals[0] if len(vals) == 1 else vals
            else:
                pending_key = key
            line = ""
    return root


# 'consistent' in reference control files means "same flux, hand-written
# Jacobian" - and those hand-written Jacobians freeze the wave speeds, so it
# maps to our FROZEN linearization
_FLUX_MAP = {"llf": "LLF", "vanleer": "VANLEER", "ausm": "AUSM",
             "ausmplus": "AUSMPLUS", "roe": "ROE", "hll": "HLL",
             "hllc": "HLLC", "consistent": "CONSISTENT"}
_GRAD_MAP = {"none": "NONE", "leastsquares": "LEASTSQUARES",
             "greengauss": "GREENGAUSS"}
_LIM_MAP = {"none": "LINEAR", "weno": "WENO", "vanalbada": "VANALBADA",
            "barthjespersen": "BARTHJESPERSEN",
            "venkatakrishnan": "VENKATAKRISHNAN"}


def _lookup(table, key, what):
    try:
        return table[key.lower()]
    except KeyError:
        raise ValueError(
            f"unknown {what} '{key}' in control file; valid: "
            + ", ".join(sorted(table))) from None


def parse_control_file(path: str, mesh_file: str | None = None
                       ) -> FlowCaseConfig:
    with open(path) as f:
        tree = _parse_info(f.read())

    fc = tree.get("flow_conditions", {})
    viscous = fc.get("flow_type", "euler").lower() == "navierstokes"
    physics = PhysicsConfig(
        gamma=float(fc.get("adiabatic_index", 1.4)),
        Minf=float(fc.get("freestream_Mach_number", 0.5)),
        Tinf=float(fc.get("freestream_temperature", 288.15)),
        Reinf=float(fc.get("freestream_Reynolds_number", 5000.0)),
        Pr=float(fc.get("Prandtl_number", 0.72)),
        aoa_deg=float(fc.get("angle_of_attack", 0.0)),
        viscous=viscous,
        const_visc=str(fc.get("use_constant_viscosity", "false")).lower()
        == "true",
    )

    bcsec = tree.get("bc", {})
    bclist = []
    for key, val in bcsec.items():
        if key.startswith("bc") and isinstance(val, dict):
            vals = val.get("boundary_values", [])
            if isinstance(vals, str):
                vals = [vals]
            opts = val.get("options", [])
            if isinstance(opts, str):
                opts = [opts]
            bclist.append(BCSpec(
                marker=int(val["marker"]),
                type=val["type"].lower(),
                values=tuple(float(v) for v in vals),
                periodic_axis=int(opts[0]) if opts else 0,
            ))
    wlist = bcsec.get("listof_output_wall_boundaries", [])
    if isinstance(wlist, str):
        wlist = [wlist]
    wall_markers = tuple(int(w) for w in wlist)

    sd = tree.get("spatial_discretization", {})
    grad = _lookup(_GRAD_MAP, sd.get("gradient_method", "leastsquares"),
                   "gradient method")
    numerics = NumericsConfig(
        flux=_lookup(_FLUX_MAP, sd.get("inviscid_flux", "hllc"),
                     "inviscid flux"),
        flux_jacobian=_lookup(_FLUX_MAP,
                              tree.get("Jacobian_inviscid_flux", "consistent"),
                              "Jacobian flux"),
        gradient=grad if grad != "NONE" else "LEASTSQUARES",
        reconstruction=_lookup(_LIM_MAP, sd.get("limiter", "none"),
                               "limiter"),
        # PARITY NOTE: the reference parses 'limiter_parameter' into
        # FlowParserOptions::limiter_param but NEVER ASSIGNS it
        # (controlparser.cpp has no read for it), so every FVENS run uses the
        # default-constructed value 0.0 regardless of the control file. The
        # committed WENO regression values (regr-WENO_LeastSquares_HLLC.txt)
        # only reproduce with lambda = 0; we mirror that here. Set
        # NumericsConfig.limiter_param directly to honor a real value.
        limiter_param=0.0,
        order2=grad != "NONE",
    )

    pt = tree.get("pseudotime", {})
    stepping = pt.get("pseudotime_stepping_type", "implicit").lower()

    def ptc(sec, defaults):
        s = pt.get(sec, {})
        return PseudoTimeConfig(
            cfl_init=float(s.get("cfl_min", defaults.cfl_init)),
            cfl_fin=float(s.get("cfl_max", defaults.cfl_fin)),
            tol=float(s.get("tolerance", defaults.tol)),
            maxiter=int(s.get("max_timesteps", defaults.maxiter)),
            stepping=stepping,
        )

    main = ptc("main", PseudoTimeConfig())
    init = ptc("initialization",
               PseudoTimeConfig(cfl_init=25., cfl_fin=500., tol=1e-1,
                                maxiter=150))
    nl = NonlinearUpdateConfig(
        scheme=pt.get("nonlinear_update_scheme", "full").lower(),
        min_factor=float(pt.get("min_nonlinear_relaxation_factor", 0.2)),
    )

    io = tree.get("io", {})
    mf = mesh_file or io.get("mesh_file", "")

    # time section (controlparser.cpp:165-177): unsteady runs carry the
    # physical-time integrator settings
    tm = tree.get("time", {})
    sim_type = str(tm.get("simulation_type", "steady")).lower()
    final_time = float(tm.get("final_time", 0.0))
    time_integrator = str(tm.get("time_integrator", "TVDRK")).upper()
    time_order = int(tm.get("temporal_order", 3))
    phy_cfl = float(tm.get("physical_cfl", 0.5))

    return FlowCaseConfig(physics=physics, numerics=numerics, bcs=bclist,
                          main=main, init=init, linear=LinearSolverConfig(),
                          nl_update=nl, wall_markers=wall_markers,
                          mesh_file=mf, sim_type=sim_type,
                          final_time=final_time,
                          time_integrator=time_integrator,
                          time_order=time_order, phy_cfl=phy_cfl)
