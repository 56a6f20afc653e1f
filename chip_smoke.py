"""Smoke test of the PyTorch/CUDA port (fvens_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card, each through the three CUDA kernels'
wrappers with the launch counts zeroed just before it and read just after:

  - the large-mesh path: the inviscid cylinder of
    cases/bigmesh_case.run_solve at its full 640x320 mesh (204,800 cells,
    n = 819,200; M 0.38, HLLC, weighted least squares, LINEAR; a
    first-order starter, then the second-order main solve, CFL 500 -> 5000
    to an absolute residual of 1e-10; f32 Jacobian/Krylov inside the f64
    residual/update; FGMRES(90) at rtol 1e-2, bsgs x6, banded). Each Krylov
    iteration is one banded_apply launch (the matvec) and one launch of the
    fused bsgs kernel (the whole preconditioner apply); gmres takes its
    blocked path there by itself, whose basis appends are the row_set
    kernel;
  - the same case on the gather path (bigmesh_case.GATHER_BSGS, the twin of
    scripts/bench_bigmesh.py without --banded): the slot matvec and bsgs x6
    on slot gathers in plain PyTorch, and row_set once per Krylov
    iteration; and under the JAX package's default preconditioner
    (GATHER_BCSGS, bcsgs x3), timed over GATHER_STEPS main steps;
  - the bench path of the first slice: the banded laminar NACA0012 solve on
    naca0012_omesh(160, 80) (cases/bench_case.run_solve, 600 steps);
  - the control-file entry point, `python -m fvens_tpu_torch.cases.cli` on
    the committed cylinder ctrl and solverc at 640x320 in f64 (gather
    bsgs x6, row_set once per Krylov iteration), with every output and a
    resume from its checkpoint;
  - the schemes and steppers: every flux, gradient scheme and
    reconstruction at 640x320; the transonic NACA0012 (HLLC + WENO)
    through the CLI at 640x320 (gather bsgs x6, row_set); the banded
    cylinder with Venkatakrishnan (K1, K1b, K2); the explicit cylinder
    through the CLI; TVD-RK3 on a 512x512 periodic vortex box; the heat
    equation on a 512x512 square (V = 1 blocks) on the gather path
    (row_set) and banded (K1 and K1b with 1x1 blocks, row_set);
  - the other solver options at 640x320 on the gather path: the block
    ILU0, the aggregation multigrid, the line smoother, the matrix-free
    JVP and FD matvecs, and warm start with GCRO-DR recycling (row_set
    once per Krylov iteration of blocked GMRES);
  - the device-resident stepping modes on the 640x320 banded cylinder:
    pipelined stepping, chunks of device_steps = 8 and baked steps, each
    step a CUDA graph whose Krylov iterations sit in IF nodes, through
    K1, K1b, K2, the Givens kernel (csrc/givens_column.cu, which also
    decides the next iteration's node) and the compare-and-set kernel
    that decides the other nodes (csrc/graph_if.cu).

In order:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds csrc/banded_apply.cu, csrc/banded_bsgs.cu,
     csrc/banded_bsgs_cluster.cu, csrc/row_set.cu, csrc/givens_column.cu
     and csrc/graph_if.cu from the checkout, one
     nvcc each, all at once, and prints ptxas's
     registers, stack frame and spills for each kernel instantiation (one
     "ptxas" JSON line per library);
  3. holds each kernel against its plain PyTorch twin: banded_apply on the
     real step-0 operators of both paths (matvec K=7, D^-1 v K=1, bsgs sweep
     K=6) and of the banded 256x256 and 512x512 heat equation (1x1 blocks:
     matvec K=5, D^-1 v K=1, sweep K=4) and the fused bsgs apply on the
     same operators (at 1x1 blocks in both designs, the cluster kernel and
     the cooperative one, timed side by side), at f32 (max abs
     error <= 1e-5 max|y|) and f64 (<= 1e-12 max|y|), the fused apply also
     equal value for value to the seven-launch banded_apply sequence; and
     row_set at n = 819,200 (the 640x320 basis), 262,528 (where the TPU
     kernel's tile gate refuses the row), 1,638,400 and 819,207 (rows that
     start off a 16-byte boundary) at f32 and f64, and with a NaN norm:
     bit for bit, the other basis rows unchanged, V's storage unchanged.
     Times each call
     (CUDA events, median of TIMED_RUNS), its device time (device_ms: calls
     queued back to back behind a device-side sleep), the twin, the fused
     apply's sequence, and the matvec as one torch.sparse_bsr_tensor product
     (torch.sparse_csr_tensor at 1x1 blocks; library_ms; never on the
     path), and computes each kernel's bound; the
     fused apply also phase by phase (profile_step.bsgs_phase_times: D^-1 v
     with the first sweep, and a later sweep, beside the sequence's, with
     the solver's plan and with other shared memory), and the fixed cost of
     one of its phases where the data is negligible
     (profile_step.bsgs_phase_cost; at 1x1 blocks for both designs,
     bsgs_phase_cost_v1: a flag-chained phase against a sweep with its
     cluster barrier);
  4. runs the 640x320 cylinder solve (a warm-up solve, then the timed one):
     gmres must run blocked (n >= linear._BLOCKED_N_THRESHOLD), the main
     solve must converge to 1e-10 with a finite state, row_set must launch
     once per Krylov iteration (each appends one basis row), the fused bsgs
     kernel at least once per Krylov iteration, and banded_apply at least
     once and fewer than twice per Krylov iteration (the sweeps left it).
     The run's counts are printed beside the JAX package's TPU counts of the
     same case in BENCH_BIGMESH.json, as context only;
  5. runs the 640x320 case on the gather path once, timed (the process is
     warm from step 4): gmres must run blocked, the main solve converge to
     1e-10 with a finite state, row_set launch once per Krylov iteration,
     and neither banded kernel launch; then, with bcsgs x3, the starter and
     GATHER_STEPS main steps: finite residuals, row_set once per Krylov
     iteration, seconds and Krylov iterations per step printed;
  6. runs the first COMPARE_STEPS main steps of the 640x320 case from the
     starter's state with the fused apply and with the sequence in its
     place: Krylov iterations and residuals must be identical;
  7. runs the 160x80 cylinder with gmres forced blocked and holds it to
     the JAX package's CPU runs in records/jax_bigmesh_history.json: it
     must converge, its starter must take the record's steps (Krylov
     iterations within 2%), its first AGREE_STEPS main steps must match the
     blocked record step for step (Krylov iterations within 1, residuals
     within 1%), and its main steps and Krylov iterations must be within
     10% of the JAX package's run on either GMRES path. The two JAX runs
     agree with each other step for step until the residual nears 1e-7 and
     then part (blocked 54 steps / 1,318 iterations, classic 49 / 850), so
     an endgame nearer to one of them than 10% of the other is no fault.
     The same for the gather path against records/jax_gather_history.json:
     bsgs x6 blocked (forced) and classic, and bcsgs x3 classic, each held
     to the record of its own GMRES path step for step and, in its totals,
     to the range of the JAX package's runs of its preconditioner (10%
     for bsgs, 35% for bcsgs, whose endgame is a long stall);
  8. runs the bench solve (its first BENCH_STEPS of 600 steps), whose state
     must stay finite with at least one banded_apply and one fused bsgs
     launch per Krylov iteration. It must reach 1e-10 if the JAX package's
     own solve of the same case did (JAX_RECORD, made by
     records/jax_bench_history.py); on this generated mesh that solve does
     not converge, but cycles between residuals near 1e-3 and blowups, and
     the port's lowest residual must then be within 10x of the lowest of
     the JAX package's over the same steps;
  9. runs the first-order (starter) form of the bench solve, which must
     converge to 1e-10 through the kernels in the steps and Krylov
     iterations of the JAX package's run (JAX_RECORD);
 10. runs the bench's first steps again through the plain twins: 3 steps
     in full f64 (equal Krylov iterations per step, residuals to 1e-4), and
     the first step in mixed precision (equal iterations, the two residuals
     it determines to 1e-4). Later mixed-precision steps are not compared:
     at step 2 the f32 Krylov solve stops unconverged at 90 iterations and
     the trajectory turns chaotic (a rounding-level change becomes a
     residual tens of percent apart at step 3);
 11. holds small solves on the card, through the kernels, to the JAX
     package's histories of the same inputs (SMALL_CASES, and on the
     gather path and with the banded bjacobi preconditioner
     GATHER_SMALL_CASES);
 12. drives the control-file entry point (fvens_tpu_torch.cases.cli.main,
     in this process) on the committed cylinder ctrl and solverc (CLI_CTRL,
     CLI_SOLVERC: the same inviscid cylinder, f64 throughout, FGMRES(90) at
     a fixed rtol of 1e-2, bjacobi + ILU mapped to bsgs x6 on slot
     gathers) at CLI_MESH, 640x320, generated into a temporary directory,
     with a VTU, the surface table, the JSONL history, a checkpoint and
     functionals every CLI_FUNCTIONALS_EVERY steps: it must exit 0 and
     converge to the ctrl's tolerance, launch row_set once per Krylov
     iteration of the whole run (starter included) and no banded kernel,
     and write a VTU that parses as XML with the mesh's cells, a surface
     table of CLI_WALL_FACES faces, one history line per main step with
     finite functionals every CLI_FUNCTIONALS_EVERY steps; the same command
     again must resume from the checkpoint and end in the same
     functionals (within 1e-8);
 13. runs the CLI at CHECK_MESH and holds it to the JAX package's CLI on
     the same files (JAX_CLI_RECORD): the starter's steps exactly, the first
     AGREE_STEPS main steps step for step (Krylov iterations within 1,
     residuals within 1%), main steps and Krylov iterations within 10%,
     and the functionals within 1e-6;
 14. A: the scheme sweep on cylinder_omesh(640, 320) at a seeded state
     (SWEEP_COMBOS: each flux with least squares + LINEAR, each
     reconstruction with HLLC, Green-Gauss): each residual on the card
     equal to the port's CPU residual of the same tensors to 1e-12 and
     timed; each flux's slot Jacobian, CONSISTENT and FROZEN, equal to the
     CPU's at 160x80 to 1e-11 and timed at 640x320; printed as a table;
 15. B1: the CLI on the committed transonic NACA0012 ctrl and solverc at
     NACA_MESH (f64, gather bsgs x6, blocked GMRES), the main solve capped
     at NACA_MAIN_STEPS: row_set once per Krylov iteration, no banded
     kernel, no retried step, the relative residual within NACA_TRACK x of
     the card's readings NACA_CARD_RELRES and at most NACA_LEVEL at the
     cap. Then at 160x80, capped at NACA_CHECK_MAIN_STEPS of the record's
     1,788 main steps, against the JAX package's CLI on the same files
     (JAX_SCHEMES_RECORD): the starter step for step, the first
     NACA_AGREE_STEPS main steps step for step (Krylov iterations equal,
     residuals to 1e-9 relative with a floor of 1e-12 of the first), then
     the relative residual within NACA_TRACK x of the record's at each
     NACA_CHECK_AT step;
 16. B2: the banded 640x320 cylinder with Venkatakrishnan (K = 20), mixed
     precision, the starter and LIMITED_MAIN_STEPS main steps through K1,
     K1b and K2: finite, falling residuals;
 17. C: the CLI on the committed explicit cylinder ctrl at EXPLICIT_MESH to
     its tolerance or EXPLICIT_MAX_STEPS steps (steps per second, cell
     updates per second), then its first EXPLICIT_AGREE_STEPS steps at
     160x80 against the record to 1e-10 relative; no kernel launches;
 18. D: TVD-RK3 at CFL 0.8 on the VORTEX_N periodic vortex box to VORTEX_T:
     mass to 1e-10, L2 density error under half the vortex's deviation and
     at least 4x below the VORTEX_COARSE run's; at 64x64 to t = 0.5 the
     record's steps, t to 1e-12 and state to 1e-10;
 19. E: the heat equation (DiffusionFV, V = 1) on unit_square(n) quads at
     HEAT_N, implicit to 1e-9, on the gather path (bcsgs x3) and banded
     (HEAT_BANDED, bsgs x6: K1 and K1b's cluster kernel with 1x1 blocks):
     converged, row_set once per Krylov iteration at 512x512 (blocked GMRES
     at n = 262,144), K1 once per Krylov iteration and once per GMRES
     cycle, the cluster kernel once per Krylov iteration (and once per
     cycle, blocked) and the cooperative bsgs kernel never,
     L2 error order in [1.9, 2.1] on each path; the banded solves take the
     steps of the JAX package's CPU run (JAX_HEAT_BANDED_RECORD), its
     Krylov iterations within 1 and its L2 error to 1e-8 relative.

Each path of steps 15-19 prints one line (naca cli, limited banded,
explicit cli, vortex, heat, heat banded) with its steps, Krylov
iterations, launches, wall time and rates, and the card's name and power
limit.

 20. F: the JAX package's other solver options on the gather path
     (cases/bigmesh_case.OPTIONS) at OPTIONS_MESH, 640x320, mixed
     precision, each on a line of its own with the card: F1, the whole
     case under the fixed-point block ILU0 (GATHER_ILU0), the main solve
     to 1e-10 or ILU_MAIN_STEPS steps (steps, Krylov iterations, seconds
     per main step, the factorization and apply times); F2, the bsgs x6
     starter, then OPTION_STEPS main steps (the JVP: JVP_STEPS) from its
     state under each of
     amg, bline, the exact JVP matvec and the FD shell (seconds and Krylov
     iterations per step, the residual reached, the pc's set-up and apply,
     the AMG hierarchy, the lines), amg's first steps twice, bit for bit,
     and the line smoother's apply on the NACA0012 O-mesh, where lines
     form; F3, from the same state, bsgs x6 with warm start and GCRO-DR
     recycling (k = 16) to 1e-10 or RECYCLE_MAIN_STEPS steps, beside the
     plain bsgs x6 solve of step 5. Each: finite, falling residuals and
     row_set once per Krylov iteration of blocked GMRES (gmres_dr runs
     the classic path). Then at OPTIONS_CHECK_MESH, 160x80, each option
     against the JAX package's CPU run of it
     (records/jax_solver_options_history.json): the starter's steps, and
     the first OPTIONS_AGREE main steps step for step (Krylov iterations
     within 1, residuals within 1%).

 21. G: the domain-decomposed path (fvens_tpu_torch/dist/), each line
     naming its backend. NCCL refuses two ranks on one card, so: G1, the
     DIST_MESH (640x320) banded case through
     casesolvers.DistributedFlowCase on one NCCL rank, against the
     one-device banded solve with GMRES forced onto the classic path a
     distributed solve takes: the starter's steps equal, the first
     DIST_AGREE_STEPS main residuals to 1e-8 relative, the main steps
     within 10%, the functionals to 1e-8, K1 and the fused K1b (one part
     has no rest list) at least once per Krylov iteration and equal to
     their twins on the part's operators, its wall split into set-up,
     starter, main solve and gather (the one-device solve, and G2's
     one-device forms, run in this process while the rank does). G2 and
     G3, for D in DIST_PARTS: D ranks sharing the card over gloo,
     host-staged (G2's times are no scaling result), and beside them G1's
     CLI with --devices 1 (subprocesses: its rank writes to the
     subprocess's output) on the committed cylinder ctrl at DIST_CLI_MESH
     (160x80) with every output, and again resuming, its functionals
     within 1e-8 of step 13's one-device CLI at that mesh (CL
     absolutely). The worlds of each D run at once. G2: the
     sharded residual at a seeded state and one bjacobi step at rtol 1e-10
     equal to the one-device ones (tests/test_dist.py's tolerances), each
     part's K1 + rest list and bsgs sequence + rest list equal to their
     twins (f32, 1e-5 of max|y|), DIST_STEPS main steps of the banded
     bsgs x6 solve from G1's starter state scattered to the parts, finite
     and falling, with K1's launches per Krylov iteration counted (s/step,
     Krylov iterations, halo cells, rounds, bytes and us per exchange per
     rank); G3, the DIST_CHECK_MESH (160x80) case through
     DistributedFlowCase on contiguous index blocks against
     records/jax_dist_history.json's runs of that partition, within the
     limits the record states (the starter equal, the first main steps step
     for step, converged in at most 25% more main steps and 35% more
     Krylov iterations, and in at least 25% and 35% fewer than the record
     took to come within 10x the tolerance; functionals to 1e-8, CL to
     5e-9), and at D = 2 (DIST_BFS_PARTS) on partition_mesh's own BFS
     parts the starter and the first 20 main steps step for step against
     the record's BFS run.

 22. H: precision scheduling and the distributed dry run. H1, the banded
     640x320 cylinder with two_phase = TWO_PHASE_GATE
     (bigmesh_case.run_solve: phase A the whole case in f32 to the
     absolute gate, phase B in f64 from phase A's last CFL), one timed
     solve: converged to 1e-10, finite, the entropy error
     within the record's limit of step 4's single-phase solve's; per
     phase of the timed solve row_set once per Krylov iteration, the fused
     K1b at least once and K1 at least once and fewer than twice per
     Krylov iteration; each phase's steps, Krylov iterations, wall and ms
     per main step beside the single-phase solve's; K1 and K1b against
     their twins at f32 on phase A's operators (the f32 mesh and state).
     H1b, the same at TWO_PHASE_CHECK_MESH (160x80) with phase B run to
     its 600 steps without the solver's verdict, and the bench form on
     the gather path (phase B's first 20 steps), against
     JAX_TWO_PHASE_RECORD within its limits (the starter, phase A's first
     steps step for step, phase A's steps, phase B's starting CFL, phase
     B's lowest residual against the spread of the record's two runs);
     beside it H2, dryrun_multichip(D) for D in DRYRUN_PARTS on cuda:0
     over gloo, host-staged, both worlds at once, each against
     JAX_DRYRUN_RECORD (halo statistics, the five steps' Krylov
     iterations and mini-solve steps equal, residuals to 1e-5, the
     mini-solves' Krylov iterations within 10%), K1 launched on the
     banded step.

 23. I: device-resident stepping (solver/device_stepping.py). I5, the
     Givens kernel against its twin bit for bit (f32 and f64, iterations
     GIVENS_J of FGMRES(90), a NaN column, a dead call) and timed beside
     its twin on the card and its bound; IF_NODES IF nodes in the generic
     form (a set-condition kernel in front of each) and in the chained form
     (each node set where its predicate is computed), replayed with their
     condition true and false (each body ran exactly when it held), a dead
     and a live node of each form timed per node, against the host's way
     of deciding (.item()); the compare-and-set kernel against its twin and
     the torch expressions it replaces, bit for bit at f32 and f64 (values
     straddling the product's rounding), and timed; a Krylov chain of
     IF_NODES Givens updates in groups, stopped part way by its tolerance:
     exactly the live bodies ran, the state equals the twin's, the nodes
     reached counted on the card; gmres_device on the 640x320 step-0
     banded operators captured and eager, equal bit for bit. I1,
     bigmesh_case.run_solve(pipeline=True) at 640x320, a warm-up and a
     timed solve; I2, device_steps = 8 and bake_mesh, one timed solve
     each; every burst, chunk and baked step queued under
     torch.cuda.set_sync_debug_mode("error"). Each converged to 1e-10
     with a finite state, its starter and main steps and Krylov
     iterations within STEPPING_SLACK of step 4's single-step solve, and
     with the launches counted on the card (solver/device_counts): per
     Krylov iteration one row_set, one Givens update, K1b at least once,
     K1 once or twice, a compare-and-set launch at least once; no
     set-condition kernel; the IF nodes reached per main step at most
     2 x its Krylov iterations + 15 (printed per starter and per main step
     of the timed solve); ms per main step (with and without the graph
     captures) and per Krylov iteration beside step 4's; traced main steps
     (the host-controlled and the captured step, a chunk) with the device
     busy share. I3, the three modes at STEPPING_CHECK_MESH against
     JAX_BIGMESH_RECORD (pipeline) and JAX_STEPPING_RECORD; I4, the CLI
     with --pipeline at CHECK_MESH against JAX_CLI_RECORD.

 24. J: the distributed step as one device program (dist/shard.py:
     DistributedBackwardEuler._device_step, gmres_device over reduced
     inner products). J1, in G1's world on the same NCCL rank after G1's
     host-loop solve: the 640x320 banded cylinder through
     DistributedFlowCase with pipeline set on the starter and the main
     solve (as the CLI's --pipeline sets it), each rank's step one CUDA
     graph with its collectives captured, against G1's host loop: the
     same starter steps, the first DIST_AGREE_STEPS main residuals within
     JAX_DIST_RECORD's agree_res (1%; the trajectories part at f32
     rounding), the main steps within 10%, the functionals to
     1e-8 (CL to JAX_DIST_RECORD's cl_abs), counted on the card K1, the
     fused K1b and the Givens kernel at least once per Krylov iteration of
     its device-form steps, IF nodes reached and no row_set; ms per starter
     and main step, capture seconds and IF nodes per step beside G1's host
     loop and the one-device pipelined step. J1b: bake_mesh for
     J_BAKED_STEPS main steps from J1's starter state, its Krylov
     iterations J1's and its residuals to J_BAKED_REL relative; the baked
     step's graph captured once more and its nodes read through the
     CUDA's libcuda (by type, at the top and inside the IF nodes' bodies,
     each body noted as its capture begins, and the NCCL kernels among
     them); whether an allreduce runs under no_host_sync. J2, in G2's D = 2 world (gloo ranks sharing
     the card: the host-staged route): J_STAGED_STEPS device-form steps
     (EAGER: the Givens and compare-and-set kernels on reduced columns)
     from G1's starter state against as many _step's, chained: the same
     Krylov iterations, the residuals to J_STAGED_REL relative; the
     solver not device_resident, and two solves with pipeline set on one
     flow printing STAGED_NOTICE once. J's seconds are taken out of G1's
     and G2/G3's phases and listed as their own.

Any failure exits non-zero before the result. The last line of standard
output is {"ok": true, "device": {...}}; the line before it holds the
kernel record (launches of banded_apply and banded_bsgs from the banded
640x320 solve of step 4, of banded_bsgs_cluster from the banded 512x512
heat solve of step 19, of row_set from the gather 640x320 solve of step
5, of givens_column, graph_if (IF nodes reached) and cond_set from I1's
pipelined solve, counted on the card, and each path's counts under
launches_by_path, the CLI of step 12 and the paths of steps 15-23 among
them, G1's, G2's and H2's summed over
their ranks, phase I's 640x320 paths counted on the card), and the one
before that the seconds each phase took.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

KERNELS = {                     # name: (source, the TPU kernel it replaces)
    "banded_apply": ("fvens_tpu_torch/csrc/banded_apply.cu",
                     "fvens_tpu/solver/pallas_banded.py:107"),
    "banded_bsgs": ("fvens_tpu_torch/csrc/banded_bsgs.cu",
                    "fvens_tpu/solver/pallas_banded.py:107"),
    # the same TPU kernel's bsgs role at 1x1 blocks (the heat equation),
    # where no band wraps
    "banded_bsgs_cluster": ("fvens_tpu_torch/csrc/banded_bsgs_cluster.cu",
                            "fvens_tpu/solver/pallas_banded.py:107"),
    "row_set": ("fvens_tpu_torch/csrc/row_set.cu",
                "fvens_tpu/solver/pallas_banded.py:254"),
    # no pl.pallas_call: the JAX package's gather path is XLA (a gather
    # and an einsum)
    "slot_gather": ("fvens_tpu_torch/csrc/slot_gather.cu",
                    "fvens_tpu/solver/linear.py bsr_matvec and "
                    "make_preconditioner's bsgs (XLA; no Pallas kernel)"),
    # no pl.pallas_call: the JAX package's Givens update is XLA inside its
    # FGMRES while loop, and its device-side control flow the loop itself
    "givens_column": ("fvens_tpu_torch/csrc/givens_column.cu",
                      "fvens_tpu/solver/linear.py:409 (rot fori_loop, no "
                      "Pallas kernel)"),
    "graph_if": ("fvens_tpu_torch/csrc/graph_if.cu",
                 "fvens_tpu/solver/linear.py:424 (lax.while_loop, lax.cond "
                 "at :471; no Pallas kernel)"),
    "cond_set": ("fvens_tpu_torch/csrc/graph_if.cu",
                 "fvens_tpu/solver/linear.py:472 (lax.cond's wn1 < 0.7 wn0; "
                 "the while loop's res > tol at :385 and the restarts' at "
                 ":527; no Pallas kernel)"),
}
TIMED_RUNS = 50
# The least time of a kernel: its bytes (each input read once, each output
# written once) over the card's memory rate, or its operations over the
# peak rate of their type, whichever is larger. H100 SXM: 3.35 TB/s of HBM,
# 67 TFLOP/s f32 outside the tensor cores, 34 TFLOP/s f64 (NVIDIA's data
# sheet).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
COMPARE_STEPS = 10               # main steps, fused pc vs the sequence
# The JAX package's starter -> main runs of the cylinder case on the CPU
# with x64 (records/jax_bigmesh_history.py), and its TPU runs of the same
# case at 640x320 (scripts/bench_bigmesh.py; counts only, as context).
JAX_BIGMESH_RECORD = "records/jax_bigmesh_history.json"
TPU_BIGMESH = "BENCH_BIGMESH.json"
CHECK_MESH = (160, 80)           # the cylinder mesh held to the JAX record
AGREE_STEPS = 30                 # main steps held to it step for step
# bcsgs x3 at 160x80: from about main step 28 its Krylov solves climb to
# 90 iterations and the residual stalls near 1e-7 for over a hundred steps;
# runs that differ in rounding only part there (the JAX package's blocked
# and classic runs after step 32, the port's CPU run after step 28) and
# end apart: the JAX runs 179 and 192 main steps, 4,983 and 5,809 Krylov
# iterations; the port's CPU run 235 and 7,074
AGREE_STEPS_BCSGS = 25
GATHER_TOTALS_SLACK = {"bsgs": 0.1, "bcsgs": 0.35}
ROWSET_SIZES = (819_200, 262_528, 1_638_400, 819_207)
JAX_GATHER_RECORD = "records/jax_gather_history.json"
GATHER_STEPS = 10                # bcsgs x3 main steps timed at 640x320
# The JAX package's 600-step runs of the bench solve and its first-order
# form on the CPU with x64 (records/jax_bench_history.py).
JAX_RECORD = "records/jax_bench_history.json"
# The control-file entry point (python -m fvens_tpu_torch.cases.cli) on the
# committed cylinder case, run in this process: at CLI_MESH in full, and at
# CHECK_MESH against the JAX package's CLI on the same files on the CPU with
# x64 (records/jax_cli_history.py). Meshes are generated into a temporary
# directory; the captured output of each run goes to CLI_LOG_DIR.
CLI_CTRL = "fvens_tpu_torch/cases/ctrl/cylinder.ctrl"
CLI_SOLVERC = "fvens_tpu_torch/cases/ctrl/cylinder.solverc"
CLI_MESH = (640, 320)
CLI_FUNCTIONALS_EVERY = 10
CLI_WALL_FACES = 640             # the cylinder wall of CLI_MESH
JAX_CLI_RECORD = "records/jax_cli_history.json"
CLI_LOG_DIR = "chiprun_out"
FUNCTIONALS = ("entropy", "CL", "CDp", "CDsf")
# The bench solve's steps here: the JAX record's lowest residual falls
# within its first 200 of 600 steps, and so does the port's.
BENCH_STEPS = 200
# This slice's paths: the schemes and the steppers. The JAX package's CPU
# runs they are held to: records/jax_schemes_history.py.
JAX_SCHEMES_RECORD = "records/jax_schemes_history.json"
SWEEP_MESH = (640, 320)          # phase A: cylinder_omesh, 204,800 cells
SWEEP_JAC_CHECK = (160, 80)      # its Jacobians held to the CPU here
SWEEP_SEED = 6
SWEEP_RUNS = 20
SWEEP_JAC_RUNS = 5
SWEEP_LIMITER_PARAM = {"WENO": 0.0, "VENKATAKRISHNAN": 20.0}
SWEEP_FLUXES = ("LLF", "VANLEER", "AUSM", "AUSMPLUS", "ROE", "HLL", "HLLC")
SWEEP_COMBOS = (tuple((f, "LEASTSQUARES", "LINEAR") for f in SWEEP_FLUXES)
                + tuple(("HLLC", "LEASTSQUARES", r) for r in (
                    "NONE", "LINEAR", "WENO", "BARTHJESPERSEN",
                    "VENKATAKRISHNAN", "VANALBADA"))
                + (("HLLC", "GREENGAUSS", "LINEAR"),))
NACA_CTRL = "fvens_tpu_torch/cases/ctrl/naca0012-transonic.ctrl"
NACA_SOLVERC = "fvens_tpu_torch/cases/ctrl/naca0012-transonic.solverc"
NACA_MESH = (640, 320)           # phase B1: naca0012_omesh, 204,800 cells
# its main solve, capped at NACA_MAIN_STEPS of the ctrl's steps (the phase
# < 120 s), does not reach the ctrl's tolerance: its relative residual is
# held within a factor NACA_TRACK of the H100's readings of the same run at
# these steps (PERF.md section 5), and at most NACA_LEVEL at the cap
NACA_MAIN_STEPS = 250
NACA_CARD_RELRES = {50: 1.860e-01, 100: 6.311e-02, 150: 3.158e-02,
                    200: 1.443e-02, 250: 5.876e-03, 300: 3.024e-03}
NACA_TRACK = 10.0
NACA_LEVEL = 1e-2
NACA_CHECK_MESH = (160, 80)      # held to the JAX record here
NACA_AGREE_STEPS = 20
# its main solve capped at NACA_CHECK_MAIN_STEPS of the record's 1,788
# (the whole run takes 84-144 s on an H100; capped to keep the phases
# within their time): the first NACA_AGREE_STEPS step for step,
# then the relative residual within NACA_TRACK of the record's at each
# NACA_CHECK_AT step
NACA_CHECK_MAIN_STEPS = 200
NACA_CHECK_AT = (100, 200)
LIMITED_MAIN_STEPS = 20          # phase B2
EXPLICIT_CTRL = "fvens_tpu_torch/cases/ctrl/cylinder-explicit.ctrl"
EXPLICIT_MESH = (640, 320)       # phase C
EXPLICIT_MAX_STEPS = 1000        # its cap
EXPLICIT_CHECK_MESH = (160, 80)
EXPLICIT_AGREE_STEPS = 200
EXPLICIT_READBACK_STEPS = 300    # steps timed with and without read-back
VORTEX_N = 512                   # phase D: 262,144 cells
VORTEX_COARSE = 128
VORTEX_T = 1.0
HEAT_N = (256, 512)              # phase E: unit_square(n) quads
HEAT_BANDED = dict(banded=True, pc="bsgs", pc_sweeps=6)  # and through K1,
#   K1b (1x1 blocks) and K2, held to:
JAX_HEAT_BANDED_RECORD = "records/jax_heat_banded_history.json"
CARD = ""                        # nvidia-smi's name and power limit

# The small solves of step 9: the bench physics and solver on
# naca0012_omesh(64, 16) from free stream. `ref` is the JAX package's
# history on the CPU with x64, (residual, Krylov iterations) per step;
# tests/test_torch_steady.py recomputes it and holds these numbers to it.
# A step passes with iterations within `iters` and a residual within
# `res` * max(its reference, the first step's). The second-order solves
# start at CFL 50, where every Krylov solve converges and the history is
# not chaotic; the first-order solve runs the bench's CFL 500 -> 5000 and
# converges to 1e-10 at step 12.
SMALL_MESH = (64, 16)
SMALL_CASES = (
    dict(order2=True, mixed=False, cfl=(50.0, 500.0), iters=0, res=1e-9,
         ref=((0.004550080908796354, 3), (0.01783935737615198, 5),
              (0.026643891582822432, 4), (0.060447761505014706, 4),
              (0.08297698897761722, 3))),
    dict(order2=True, mixed=True, cfl=(50.0, 500.0), iters=1, res=1e-4,
         ref=((0.004550080908796354, 3), (0.017839362372085044, 5),
              (0.026643886990212248, 4))),
    dict(order2=False, mixed=False, cfl=(500.0, 5000.0), iters=0, res=1e-9,
         ref=((0.00335976637892687, 8), (0.05448033407851273, 12),
              (0.005556051403003637, 10), (0.0026731315321183555, 15),
              (0.0002936375460214496, 19), (2.9127488872958013e-05, 22),
              (1.5125613948753131e-06, 27), (1.0636789925952186e-07, 25),
              (1.449988974291442e-08, 25), (1.7446546446648528e-09, 29),
              (2.962483996052874e-10, 31), (4.267653691212231e-11, 31))),
)
# The small solves on the gather path (bcsgs x3, bsgs x6 on slot gathers)
# and with the banded bjacobi preconditioner: the bench physics on
# SMALL_MESH in f64 from free stream at CFL 50 -> 500, `lin` the linear
# solver; `ref` the JAX package's history on the CPU with x64, which
# tests/test_torch_gather.py recomputes and holds these numbers to.
GATHER_SMALL_CASES = (
    dict(order2=True, mixed=False, cfl=(50.0, 500.0), iters=0, res=1e-9,
         lin=dict(banded=False, pc="bcsgs", pc_sweeps=3),
         ref=((0.004550080908796354, 4), (0.040889349625534234, 7),
              (0.030985795118297372, 5), (0.06255234089111243, 9),
              (0.06659699781482714, 8))),
    dict(order2=True, mixed=False, cfl=(50.0, 500.0), iters=0, res=1e-9,
         lin=dict(banded=False, pc="bsgs", pc_sweeps=6),
         ref=((0.004550080908796354, 3), (0.017839357376151985, 5),
              (0.026643891582820607, 4), (0.060447761505011466, 4),
              (0.08297698897761835, 3))),
    dict(order2=True, mixed=False, cfl=(50.0, 500.0), iters=0, res=1e-9,
         lin=dict(banded=True, pc="bjacobi", pc_sweeps=1),
         ref=((0.004550080908796354, 17), (0.013133674718231937, 35),
              (0.026732233221273903, 26), (0.05554944364325741, 27),
              (0.0801715646359735, 19))),
)


class SmokeFailure(RuntimeError):
    pass


PHASES = {}                      # phase name: seconds on the host clock


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    PHASES[name] = time.perf_counter() - t0
    print(f"phase {name}: {PHASES[name]:.2f} s", flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def event_ms(fn, runs=TIMED_RUNS):
    """Median CUDA-event time of fn() in ms over `runs` calls, after a
    warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, flops: float, dtype: str):
    """(bound_ms, bound_by) of work that moves nbytes and does flops."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _load(rel: str):
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           rel)) as f:
        return json.load(f)


def jax_record(order2: bool, mixed: bool) -> dict:
    """The JAX package's run of the bench solve in JAX_RECORD."""
    return next(s for s in _load(JAX_RECORD)["solves"]
                if s["order2"] == order2 and s["mixed"] == mixed)


def cylinder_record(mesh: str, record: str = JAX_BIGMESH_RECORD,
                    pc: str = "bsgs") -> list:
    """The JAX package's runs of the cylinder case on `mesh` (e.g.
    "cylinder_omesh(160, 80)") with preconditioner `pc` in `record`
    (JAX_BIGMESH_RECORD: banded bsgs; JAX_GATHER_RECORD: the gather path),
    blocked GMRES first."""
    return sorted((r for r in _load(record)["runs"]
                   if r["mesh"] == mesh and r.get("pc", "bsgs") == pc),
                  key=lambda r: not r["blocked_gmres"])


# ptxas's report of the 4x4-block instantiations before the kernels took
# V as a template argument (PERF_APPENDIX.md, PR 7, call 17), printed
# beside this build's
PTXAS_BEFORE_V4 = {
    "banded_bsgs": "64 registers each; f32 no spills, f64 8-16 bytes of "
                   "spill stores at K 5-8",
}


def build_kernels():
    """The seven CUDA libraries, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from fvens_tpu_torch.solver import banded_kernels as bk
    from fvens_tpu_torch.solver import givens_kernels as gk
    from fvens_tpu_torch.solver import graph_if
    from fvens_tpu_torch.solver import rowset_kernels as rk
    from fvens_tpu_torch.solver import slot_kernels as sk
    t0 = time.perf_counter()
    loaders = {"slot_gather": sk.load_library,
               "banded_apply": bk.load_library,
               "banded_bsgs": bk.load_bsgs_library,
               "banded_bsgs_cluster": bk.load_bsgs_cluster_library,
               "row_set": rk.load_library,
               "givens_column": gk.load_library,
               "graph_if": graph_if.load_library}
    with ThreadPoolExecutor(len(loaders)) as ex:
        jobs = {name: ex.submit(fn) for name, fn in loaders.items()}
        builds = {name: job.result() for name, job in jobs.items()}
    print(f"build: {time.perf_counter() - t0:.2f} s for all seven",
          flush=True)
    for name, build in builds.items():
        print(f"  {name}: nvcc {build.seconds:.2f} s -> "
              f"{os.path.relpath(build.path)}", flush=True)
        print("ptxas", json.dumps(dict(
            library=name, kernels=ptxas_summary(build.log),
            v4_before=PTXAS_BEFORE_V4.get(name))), flush=True)


def ptxas_summary(log: str) -> list:
    """Per kernel in nvcc's -Xptxas -v output: its name (the banded
    kernels' as dtype, block size V and, for the fused bsgs kernel, K
    bands), its registers, stack frame and spill bytes."""
    import re
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            t = re.search(r"bsgs_kernelI([fd])Li(\d+)ELi(\d+)E", name)
            a = re.search(r"apply_kernelI([fd])Li(\d+)E", name)
            c = re.search(r"cluster_kernelI([fd])Li(\d+)E", name)
            if c:
                dtype = "f32" if c.group(1) == "f" else "f64"
                name = f"{dtype} V=1 K={c.group(2)}"
            elif t:
                dtype = "f32" if t.group(1) == "f" else "f64"
                name = f"{dtype} V={t.group(2)} K={t.group(3)}"
            elif a:
                dtype = "f32" if a.group(1) == "f" else "f64"
                name = f"{dtype} V={a.group(2)}"
            cur = dict(kernel=name)
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def sparse_library_matvec(D, Bt, offsets):
    """The matvec as one PyTorch call, for its time only (never on the
    path): a torch.sparse_bsr_tensor of its VxV blocks (at V = 1 a
    torch.sparse_csr_tensor: cuSPARSE's SpMV on the card), bands of one
    shift summed (the O-mesh seam bands share a shift with interior bands,
    and only one of the two is nonzero at a cell), times x. Returns
    mv(x)."""
    import torch
    from fvens_tpu_torch.solver.banded import _norm_offsets

    NC, V = D.shape[0], D.shape[-1]
    dms = (0,) + _norm_offsets(offsets, NC)
    blocks = torch.cat([D.permute(1, 2, 0)[None], Bt])      # (K+1, V, V, NC)
    shifts = sorted(set(dms))
    merged = torch.stack([sum(blocks[k] for k, d in enumerate(dms)
                              if d == u) for u in shifts])
    cells = torch.arange(NC, device=D.device)
    cols = torch.stack([(cells + u) % NC for u in shifts], dim=1)
    cols, order = cols.sort(dim=1)
    vals = merged.permute(3, 0, 1, 2).gather(
        1, order[:, :, None, None].expand(-1, -1, V, V))
    crow = torch.arange(0, NC * len(shifts) + 1, len(shifts),
                        device=D.device)
    if V == 1:
        A = torch.sparse_csr_tensor(crow, cols.reshape(-1),
                                    vals.reshape(-1).contiguous(),
                                    size=(NC, NC), check_invariants=False)
    else:
        A = torch.sparse_bsr_tensor(crow, cols.reshape(-1),
                                    vals.reshape(-1, V, V).contiguous(),
                                    size=(V * NC, V * NC),
                                    check_invariants=False)

    def mv(x):
        return (A @ x.reshape(-1, 1)).reshape(NC, V)
    return mv


def banded_checks(dev, path: str, make, state=None, phase_times=True,
                  precisions=((True, 1e-5), (False, 1e-12))):
    """The K1 kernels against their plain twins on the step-0 operators of
    one path, at f32 (the mixed-precision Krylov system) and f64 (mixed
    precision off): banded_apply in its three roles (matvec with the
    diagonal, D^-1 v K=1, bsgs sweep; K=7, 1, 6 on the O-meshes' 4x4
    blocks, 5, 1, 4 on the heat equation's 1x1 blocks), and the fused bsgs
    apply (at 1x1 blocks in both designs, the cluster kernel and the
    cooperative one, timed side by side: a row each), which must also
    equal the seven-launch banded_apply sequence value for value.
    `make(mixed)` returns (solver, mesh); `state(mesh)`
    the state of step 0 (default: the case's initial state);
    `phase_times`: time the fused apply phase by phase too;
    `precisions`: the (mixed, tolerance) pairs to check. Returns
    (banded_apply rows, bsgs rows)."""
    import torch
    from fvens_tpu_torch.cases.casesolvers import initial_state
    from fvens_tpu_torch.cases.profile_step import (bsgs_phase_times,
                                                    device_ms)
    from fvens_tpu_torch.solver import banded as tb
    from fvens_tpu_torch.solver import banded_kernels as bk

    rng = np.random.default_rng(0)
    rows, frows = [], []
    for mixed, tol in precisions:
        solver, cm = make(mixed)
        u0 = initial_state(solver.space, cm) if state is None else state(cm)
        _, _, ops = solver.step_operators(cm, u0, solver.cfg.cfl_init)
        dtype = ops.D.dtype
        dname = str(dtype)[6:]
        it = ops.D.element_size()
        V = ops.D.shape[-1]
        bands7, d7 = bk.matvec_bands(ops.D, ops.Bt, ops.bl.offsets)
        (bands1, d1), (bandsn, dms_n) = bk.bsgs_bands(ops.Dinv, ops.DNbt,
                                                   ops.bl.offsets)
        x = torch.from_numpy(rng.standard_normal((cm.NC, V))).to(dev, dtype)
        base = bk.banded_apply_plain(bands1, x, d1)
        # the cells where each band is nonzero: the diagonal everywhere,
        # the others over BandedStructure.support (the seam bands one ring)
        whole = ((0, cm.NC),)
        support = tuple(ops.bl.support)
        cases = (("matvec", bands7, d7, 1.0, None, whole + support),
                 ("dinv", bands1, d1, 1.0, None, whole),
                 ("sweep", bandsn, dms_n, -1.0, base, support))
        for name, bands, dms, sign, b, sup in cases:
            y = bk.banded_apply(bands, x, dms, sign, b)
            torch.cuda.synchronize()
            yp = bk.banded_apply_plain(bands, x, dms, sign, b)
            err = float((y - yp).abs().max())
            scale = float(yp.abs().max())
            row = dict(path=path, NC=cm.NC, op=name, V=V, K=bands.shape[0],
                       dtype=dname, max_abs_err=err,
                       max_abs_y=scale, tol=tol * scale)
            check(np.isfinite(err) and err <= tol * scale,
                  f"banded_apply disagrees with its twin: {row}")
            apply = bk.BandedApply(bands, dms, sign)
            row["ms"] = event_ms(lambda: apply(x, b))
            row["device_ms"] = device_ms(lambda: apply(x, b))
            row["plain_ms"] = event_ms(lambda: bk.banded_apply_plain(
                bands, x, dms, sign, b))
            # what the function needs: each band over its support, x and
            # the output (and base) once
            band_cells = sum(hi - lo for lo, hi in sup)
            vecs = (3 if b is not None else 2) * V * cm.NC
            row["bound_bytes"] = (V * V * band_cells + vecs) * it
            row["bound_ms"], row["bound_by"] = bound(
                row["bound_bytes"], 2 * V * V * band_cells, dname)
            row["bound_all_cells_ms"], _ = bound(
                (V * V * bands.shape[0] * cm.NC + vecs) * it, 0, dname)
            if name == "matvec":
                row.update(library_matvec(ops, x, yp, tol))
            rows.append(row)
            print("banded_apply check", json.dumps(row), flush=True)

        # the fused bsgs apply: = the sequence, ~ the twin; at 1x1 blocks
        # in both designs, timed side by side
        sweeps = solver.lin.pc_sweeps
        seq = bk.make_banded_bsgs_sequence(ops.Dinv, ops.DNbt,
                                           ops.bl.offsets, sweeps)
        twin = tb.make_banded_bsgs(ops.Dinv, ops.DNbt, ops.bl.offsets, sweeps)
        zs = seq(x)
        zp = twin(x)
        scale = float(zp.abs().max())
        # what this operator needs: the bands over their supports only
        band_cells = sum(hi - lo for lo, hi in ops.bl.support)
        bound_bytes = (V * V * band_cells + (V * V + 2 * V) * cm.NC) * it
        bound_ms, bound_by = bound(
            bound_bytes,
            2 * V * V * (cm.NC + sweeps * band_cells) + V * sweeps * cm.NC,
            dname)
        common = dict(sequence_ms=event_ms(lambda: seq(x)),
                      plain_ms=event_ms(lambda: twin(x)),
                      sequence_device_ms=device_ms(lambda: seq(x)),
                      bound_bytes=bound_bytes, bound_ms=bound_ms,
                      bound_by=bound_by)
        common["bound_all_cells_ms"], _ = bound(
            ((1 + len(dms_n)) * V * V + 2 * V) * cm.NC * it, 0, dname)
        for design in bk.DESIGNS if V == 1 else (None,):
            fused = bk.BsgsApply(bands1, bandsn, dms_n, sweeps,
                                 ops.bl.support, design=design)
            f0, n0 = bk.bsgs_apply.launches, bk.banded_apply.launches
            c0 = bk.bsgs_apply.cluster_launches
            z = fused(x)
            torch.cuda.synchronize()
            cluster = fused.design == "cluster"
            check((bk.bsgs_apply.launches - f0,
                   bk.bsgs_apply.cluster_launches - c0,
                   bk.banded_apply.launches - n0)
                  == ((0, 1, 0) if cluster else (1, 0, 0)),
                  f"the fused bsgs apply ({fused.design}) is not one launch "
                  "of its kernel")
            err = float((z - zp).abs().max())
            p = fused.plan
            row = dict(path=path, NC=cm.NC, V=V, K=len(dms_n),
                       sweeps=sweeps, dtype=dname, design=fused.design,
                       **(dict(cluster=p.cluster, clusters=p.clusters,
                               owned=p.owned, slice=p.slice)
                          if cluster else
                          dict(blocks=p.blocks, chunk=p.chunk,
                               n_res=p.n_res)),
                       smem_bytes=p.smem_bytes,
                       equal_to_sequence=bool(torch.equal(z, zs)),
                       max_abs_err=err, max_abs_y=scale, tol=tol * scale)
            check(row["equal_to_sequence"],
                  f"the fused bsgs apply differs from the sequence: {row}")
            check(np.isfinite(err) and err <= tol * scale,
                  f"the fused bsgs apply disagrees with its twin: {row}")
            row.update(common, ms=event_ms(lambda: fused(x)),
                       device_ms=device_ms(lambda: fused(x)))
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            row["sequence_bound_share"] = (row["bound_ms"]
                                           / row["sequence_device_ms"])
            row["fused_over_sequence"] = (row["device_ms"]
                                          / row["sequence_device_ms"])
            if phase_times:
                row["phases"] = bsgs_phase_times(bands1, bandsn, dms_n,
                                                 ops.bl.support, sweeps, x)
            frows.append(row)
            print("banded_bsgs check", json.dumps(row), flush=True)
    return rows, frows


def library_matvec(ops, x, want, tol) -> dict:
    """library_ms of the matvec: one torch.sparse_bsr_tensor product (4x4
    blocks) or torch.sparse_csr_tensor product (1x1) on the same operator
    and x, held to the twin's result; or the error that shows no such call
    runs here."""
    try:
        mv = sparse_library_matvec(ops.D, ops.Bt, ops.bl.offsets)
        y = mv(x)
    except (RuntimeError, NotImplementedError) as e:
        return dict(library_ms=None, library_error=str(e).splitlines()[0])
    err = float((y - want).abs().max())
    check(err <= tol * float(want.abs().max()),
          f"the sparse library matvec disagrees with the twin: {err}")
    return dict(library_ms=event_ms(lambda: mv(x)), library_max_abs_err=err)


def rowset_checks(dev):
    """row_set vs its plain twin on a (96, n) basis, the blocked path's
    FGMRES(90) basis, at ROWSET_SIZES, f32 and f64, and with a NaN norm at
    the first size: bit for bit (NaN where the twin has NaN), only row j
    written, in place. Times each size and dtype with the norm of w."""
    import torch
    from fvens_tpu_torch.cases.profile_step import device_ms
    from fvens_tpu_torch.solver import rowset_kernels as rk

    rng = np.random.default_rng(1)
    j = 37
    rows = []
    for n in ROWSET_SIZES:
        for dtype in (torch.float32, torch.float64):
            V = torch.from_numpy(rng.standard_normal((96, n))).to(dev, dtype)
            w = torch.from_numpy(rng.standard_normal(n)).to(dev, dtype)
            hn = torch.sqrt(torch.sum(w * w))
            row = dict(n=n, dtype=str(dtype)[6:], j=j,
                       row_offset_bytes=V[j].data_ptr() % 16,
                       max_abs_err=0.0)
            norms = [hn]
            if n == ROWSET_SIZES[0]:
                norms.append(torch.full_like(hn, float("nan")))
            for norm in norms:
                V0, ptr = V.clone(), V.data_ptr()
                out = rk.row_set(V, j, w, norm)
                torch.cuda.synchronize()
                want = rk.rowset_plain(V0.clone(), j, w, norm)
                what = f"{row}, norm {float(norm)}"
                check(out is V and V.data_ptr() == ptr,
                      f"row_set did not write the basis in place: {what}")
                check(torch.equal(V[j].isnan(), want[j].isnan())
                      and torch.equal(V[j].nan_to_num(),
                                      want[j].nan_to_num()),
                      f"row_set differs from its twin: {what}")
                check(torch.equal(V[:j], V0[:j])
                      and torch.equal(V[j + 1:], V0[j + 1:]),
                      f"row_set wrote another row: {what}")
                row["max_abs_err"] = max(row["max_abs_err"], float(
                    (V - want).nan_to_num().abs().max()))
            row["nan_norm_checked"] = len(norms) > 1
            row["ms"] = event_ms(lambda: rk.row_set(V, j, w, hn))
            row["device_ms"] = device_ms(lambda: rk.row_set(V, j, w, hn),
                                         n=200)
            row["plain_ms"] = event_ms(lambda: rk.rowset_plain(V, j, w, hn))
            row["bound_ms"], row["bound_by"] = bound(
                (2 * n + 1) * V.element_size(), n, row["dtype"])
            rows.append(row)
            print("row_set check", json.dumps(row), flush=True)
            del V, V0, want
    return rows


def cylinder_solvers(dev):
    """make(mixed) -> (main solver, mesh) of the 640x320 cylinder case."""
    import dataclasses

    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.cases.casesolvers import SteadyFlowCase, build_space
    case, cm, _ = bigmesh_case.build_case(dev, *bigmesh_case.BIGMESH)

    def make(mixed):
        cfg = case.cfg
        if not mixed:
            cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
                cfg.linear, mixed_precision=False))
        return SteadyFlowCase(cfg)._make_solver(build_space(cfg),
                                                cfg.main), cm
    return make


def cylinder_path(dev):
    """The large-mesh main path, counted: bigmesh_case.run_solve at
    640x320. Returns (report, launches)."""
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.solver import linear

    torch.cuda.synchronize()
    zero_counts()
    u, rep = bigmesh_case.run_solve(dev)
    torch.cuda.synchronize()
    launches = read_counts()
    print("cylinder solve", json.dumps(dict(rep, launches=launches)),
          flush=True)
    tpu = next(r for r in _load(TPU_BIGMESH)["runs"]
               if r["size"] == "640x320" and r.get("banded")
               and r.get("stop") == "abs" and r["platform"] == "tpu")
    print(f"context, no check: the JAX package's TPU run of this case "
          f"({TPU_BIGMESH}) took {tpu['steps']} main steps and "
          f"{tpu['lin_iters']} Krylov iterations; this run "
          f"{rep['main_steps']} and {rep['main_krylov_iters']}", flush=True)
    its = rep["krylov_iters_all"]
    check(rep["n"] >= linear._BLOCKED_N_THRESHOLD and rep["blocked"],
          f"n = {rep['n']} is below the blocked-GMRES threshold")
    check(rep["converged"] and rep["abs_res"] <= bigmesh_case.TOL_ABS,
          f"the cylinder solve did not converge to {bigmesh_case.TOL_ABS}: "
          f"{rep['abs_res']!r} after {rep['main_steps']} steps")
    check(u.dtype == torch.float64 and bool(torch.isfinite(u).all())
          and np.isfinite(rep["entropy"]), "non-finite cylinder solution")
    check(its > 0 and launches["row_set"] == its,
          f"{launches['row_set']} row_set launches for {its} basis appends")
    check(launches["banded_bsgs"] >= its,
          f"{launches['banded_bsgs']} fused bsgs launches < {its} Krylov "
          "iterations")
    check(its <= launches["banded_apply"] < 2 * its,
          f"{launches['banded_apply']} banded_apply launches for {its} "
          "Krylov iterations: not one matvec each (plus one per cycle)")
    return rep, launches


def gather_path(dev):
    """The gather path, counted: bigmesh_case.run_solve at 640x320 with
    GATHER_BSGS, one solve (the process is warm from the banded one).
    Returns (report, launches)."""
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.solver import linear

    torch.cuda.synchronize()
    zero_counts()
    u, rep = bigmesh_case.run_solve(dev, warmup=False,
                                    **bigmesh_case.GATHER_BSGS)
    torch.cuda.synchronize()
    launches = read_counts()
    print("cylinder gather solve", json.dumps(dict(rep, launches=launches)),
          flush=True)
    its = rep["krylov_iters_all"]
    check(rep["n"] >= linear._BLOCKED_N_THRESHOLD and rep["blocked"]
          and not rep["banded"], f"the gather solve is not blocked: {rep}")
    check(rep["converged"] and rep["abs_res"] <= bigmesh_case.TOL_ABS,
          f"the gather solve did not converge to {bigmesh_case.TOL_ABS}: "
          f"{rep['abs_res']!r} after {rep['main_steps']} steps")
    check(u.dtype == torch.float64 and bool(torch.isfinite(u).all())
          and np.isfinite(rep["entropy"]), "non-finite gather solution")
    check(its > 0 and launches["row_set"] == its,
          f"{launches['row_set']} row_set launches for {its} basis appends")
    check(launches["banded_apply"] == launches["banded_bsgs"] == 0,
          f"the gather solve launched a banded kernel: {launches}")
    # a bsgs apply and a matvec a Krylov iteration, and each cycle's
    # residual matvec and trailing apply: one slot kernel call each
    check(launches["slot_gather"] >= 2 * its,
          f"{launches['slot_gather']} slot kernel calls for {its} Krylov "
          "iterations")
    return rep, launches


def bcsgs_steps(dev):
    """The 640x320 case with GATHER_BCSGS: the starter, then GATHER_STEPS
    main steps, timed, with finite residuals and one row_set launch per
    Krylov iteration. Returns the launches of the main steps."""
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.cases.casesolvers import build_space

    case, cm, u = bigmesh_case.build_case(dev, *bigmesh_case.BIGMESH,
                                          **bigmesh_case.GATHER_BCSGS)
    t0 = time.perf_counter()
    u = case.execute_starter(cm, u)
    torch.cuda.synchronize()
    starter_s = time.perf_counter() - t0
    st = case.starter_info
    solver = case._make_solver(build_space(case.cfg), case.cfg.main)
    zero_counts()
    t0 = time.perf_counter()
    u, info = solver.solve(cm, u, max_steps=GATHER_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    its = info.total_lin_iters
    print("cylinder bcsgs steps", json.dumps(dict(
        pc="bcsgs", pc_sweeps=case.cfg.linear.pc_sweeps,
        starter_steps=st.steps, starter_krylov_iters=st.total_lin_iters,
        starter_s=starter_s, main_steps=info.steps, krylov_iters=its,
        wall_s=wall, s_per_step=wall / max(info.steps, 1),
        krylov_iters_per_step=its / max(info.steps, 1),
        cell_updates_per_s=cm.n_cells * info.steps / wall,
        residuals=[h[2] for h in info.history], launches=launches)),
        flush=True)
    check(info.steps == GATHER_STEPS and its > 0,
          f"the bcsgs run took {info.steps} steps")
    check(all(np.isfinite(h[2]) for h in info.history)
          and bool(torch.isfinite(u).all()), "non-finite bcsgs residual")
    check(launches["row_set"] == its
          and launches["banded_apply"] == launches["banded_bsgs"] == 0,
          f"bcsgs launches {launches} for {its} Krylov iterations")
    return launches


def zero_counts():
    from fvens_tpu_torch.solver import banded_kernels as bk
    from fvens_tpu_torch.solver import givens_kernels as gk
    from fvens_tpu_torch.solver import graph_if
    from fvens_tpu_torch.solver import rowset_kernels as rk
    from fvens_tpu_torch.solver import slot_kernels as sk
    bk.banded_apply.launches = bk.bsgs_apply.launches = 0
    bk.bsgs_apply.cluster_launches = 0
    rk.row_set.launches = gk.givens_column.launches = 0
    graph_if.GraphControl.launches = graph_if.cond_set.launches = 0
    sk.SlotKernel.launches = 0


def read_counts() -> dict:
    """The host launch counts of every kernel: a launch captured into a
    graph counts once, at capture (phase I reads its own on the card)."""
    from fvens_tpu_torch.entry import kernel_launches
    from fvens_tpu_torch.solver import banded_kernels as bk
    from fvens_tpu_torch.solver import givens_kernels as gk
    from fvens_tpu_torch.solver import graph_if
    from fvens_tpu_torch.solver import slot_kernels as sk
    return dict(kernel_launches(),
                slot_gather=sk.SlotKernel.launches,
                banded_bsgs_cluster=bk.bsgs_apply.cluster_launches,
                givens_column=gk.givens_column.launches,
                graph_if=graph_if.GraphControl.launches,
                cond_set=graph_if.cond_set.launches)


# the slot kernel against the formula it replaced (index_select, bmm),
# of max|y|: f32, f64 (the sum order differs)
SLOT_TOL = {"float32": 1e-5, "float64": 1e-13}


def slot_checks(dev) -> list:
    """The slot kernel in both roles at 640x320 on the NACA0012 O-mesh's
    gather operators, f32 and f64 (profile_step.slot_kernel_times): held
    to the formula it replaced, and timed beside its twin and that
    formula."""
    from fvens_tpu_torch.cases.profile_step import slot_kernel_times
    rows = slot_kernel_times(dev)
    for r in rows:
        check(r["rel_err"] <= SLOT_TOL[r["dtype"]],
              f"slot kernel {r['role']} {r['dtype']}: {r['rel_err']!r} of "
              f"max|y| from the formula")
    return rows


def fused_vs_sequence(dev):
    """The first COMPARE_STEPS main steps of the 640x320 case, from the
    starter's state, with the fused bsgs apply (the solver's) and with the
    seven-launch sequence in its place: identical Krylov iterations and
    residuals, step for step."""
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.cases.casesolvers import build_space
    from fvens_tpu_torch.solver import banded_kernels as bk

    fcase, cm, u = bigmesh_case.build_case(dev, *bigmesh_case.BIGMESH)
    u = fcase.execute_starter(cm, u)
    hist = {}
    for name in ("fused", "sequence"):
        solver = fcase._make_solver(build_space(fcase.cfg), fcase.cfg.main)
        if name == "sequence":
            def seq_operators(ops, solver=solver):
                mv, _ = type(solver)._linear_operators(solver, ops)
                return mv, bk.make_banded_bsgs_sequence(
                    ops.Dinv, ops.DNbt, ops.bl.offsets, solver.lin.pc_sweeps)
            solver._linear_operators = seq_operators
        zero_counts()
        t0 = time.perf_counter()
        _, info = solver.solve(cm, u, max_steps=COMPARE_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_counts()
        its = info.total_lin_iters
        hist[name] = info.history
        print(f"{name} pc: {COMPARE_STEPS} main steps, {its} Krylov "
              f"iterations in {wall:.3f} s, launches {json.dumps(n)}, "
              f"residuals {[h[2] for h in info.history]}", flush=True)
        check(info.steps == COMPARE_STEPS and its > 0,
              f"the {name} run took {info.steps} steps")
        if name == "fused":
            check(n["banded_bsgs"] >= its and n["banded_apply"] < 2 * its,
                  f"the fused run did not take the fused kernel: {n}")
        else:
            check(n["banded_bsgs"] == 0 and n["banded_apply"] >= 8 * its,
                  f"the sequence run did not take the sequence: {n}")
    check(hist["fused"] == hist["sequence"],
          "the fused and sequence runs differ: "
          f"{hist['fused']} vs {hist['sequence']}")


def cylinder_vs_record(dev, record=JAX_BIGMESH_RECORD, lin=None,
                       blocked=True):
    """The CHECK_MESH cylinder (`lin` as bigmesh_case.case_config's banded,
    pc and pc_sweeps; default the banded case) with gmres forced blocked
    or on its classic path, against the JAX package's runs in `record`:
    the run of the same GMRES path step for step over the first main steps
    (AGREE_STEPS, AGREE_STEPS_BCSGS), and in the totals: the banded case
    within 10% of either run of its record; the gather path within
    GATHER_TOTALS_SLACK of the range of the JAX package's runs of its
    preconditioner in both records (bsgs: banded and gather, blocked and
    classic, the same operator summed in other orders). Their endgames
    part near the f32 floor of the Krylov solves: at 160x80 the four bsgs
    runs take 850 to 1,318 Krylov iterations, and the port's own runs on
    the CPU 881 to 955; for bcsgs see AGREE_STEPS_BCSGS."""
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.solver import linear

    lin = lin or {}
    mesh = f"cylinder_omesh{CHECK_MESH}"
    recs = cylinder_record(mesh, record, lin.get("pc", "bsgs"))
    blk = next((r for r in recs if r["blocked_gmres"] == blocked), None)
    check(blk is not None, f"no record of {mesh} {lin} blocked={blocked}")
    saved = linear._BLOCKED_N_THRESHOLD
    if blocked:
        linear._BLOCKED_N_THRESHOLD = 0
    try:
        case, cm, u0 = bigmesh_case.build_case(dev, *CHECK_MESH, **lin)
        n0 = dict(read_counts())
        u, info = case.solve(cm, u0)
        torch.cuda.synchronize()
        n1 = read_counts()
    finally:
        linear._BLOCKED_N_THRESHOLD = saved
    appends = n1["row_set"] - n0["row_set"]
    st = case.starter_info
    path = "blocked" if blocked else "classic"
    print(f"{mesh} {lin or 'banded'} {path}: starter {st.steps} steps / "
          f"{st.total_lin_iters} iterations, main {info.steps} / "
          f"{info.total_lin_iters}, final {info.finalres!r}; the JAX "
          "package's: " + "; ".join(
              f"{'blocked' if r['blocked_gmres'] else 'classic'} starter "
              f"{r['starter']['steps']} / {r['starter']['krylov_iters']}, "
              f"main {r['main']['steps']} / {r['main']['krylov_iters']}"
              for r in recs), flush=True)
    check(info.converged and bool(torch.isfinite(u).all()),
          f"the {mesh} solve did not converge")
    check(appends == (st.total_lin_iters + info.total_lin_iters
                      if blocked else 0),
          f"{appends} row_set launches: gmres did not run {path}")
    if lin.get("banded") is False:
        check(n1["banded_apply"] == n0["banded_apply"]
              and n1["banded_bsgs"] == n0["banded_bsgs"],
              "the gather run launched a banded kernel")
    s = blk["starter"]
    check(st.steps == s["steps"] and abs(st.total_lin_iters
                                         - s["krylov_iters"])
          <= 0.02 * s["krylov_iters"],
          "the starter departs from the JAX package's")
    ref = blk["main"]["history"]
    agree = AGREE_STEPS_BCSGS if lin.get("pc") == "bcsgs" else AGREE_STEPS
    check(len(info.history) >= agree,
          f"the main solve took only {len(info.history)} steps")
    for k in range(agree):
        (_, res_ref, _, it_ref), h = ref[k], info.history[k]
        check(abs(h[4] - it_ref) <= 1 and abs(h[2] - res_ref)
              <= 0.01 * res_ref,
              f"main step {k + 1}: iterations {h[4]} vs {it_ref}, residual "
              f"{h[2]!r} vs {res_ref!r}")

    if lin.get("banded") is False:
        refs = [r for rec in (JAX_BIGMESH_RECORD, JAX_GATHER_RECORD)
                for r in cylinder_record(mesh, rec, lin["pc"])]
        slack = GATHER_TOTALS_SLACK[lin["pc"]]
        for got, key in ((info.steps, "steps"),
                         (info.total_lin_iters, "krylov_iters")):
            vals = [r["main"][key] for r in refs]
            check((1 - slack) * min(vals) <= got <= (1 + slack) * max(vals),
                  f"main {key} {got} not within {slack:.0%} of the JAX "
                  f"package's {min(vals)}-{max(vals)}")
        return

    def near(r):
        return (abs(info.steps - r["main"]["steps"])
                <= 0.1 * r["main"]["steps"]
                and abs(info.total_lin_iters - r["main"]["krylov_iters"])
                <= 0.1 * r["main"]["krylov_iters"])
    check(any(near(r) for r in recs),
          f"main steps and iterations ({info.steps}, "
          f"{info.total_lin_iters}) are not within 10% of either JAX run")


def bench_path(dev):
    """The first slice's bench solve, counted."""
    import torch
    from fvens_tpu_torch.cases.bench_case import BENCH_MESH, TOL_ABS, run_solve

    solve, cm = run_solve(dev)
    print(f"mesh: naca0012_omesh{BENCH_MESH}, {cm.n_cells} cells", flush=True)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    u, info = solve(max_steps=BENCH_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    res = [h[2] for h in info.history]
    solve_rec = dict(converged=info.converged, steps=info.steps,
                     step_calls=len(info.step_times),
                     krylov_iters=info.total_lin_iters, wall_s=wall,
                     cell_updates_per_s=cm.n_cells * info.steps / wall,
                     launches=launches, first_res=res[0], min_res=min(res),
                     final_res=info.finalres, tol_abs=TOL_ABS)
    print("bench solve", json.dumps(solve_rec), flush=True)
    ref = jax_record(order2=True, mixed=True)
    ref_min = min(h[1] for h in ref["history"][:BENCH_STEPS])
    print("JAX package's solve", json.dumps(
        {k: ref[k] for k in ("converged", "steps", "krylov_iters",
                             "min_res", "final_res", "recoveries")}),
          f"({JAX_RECORD}); lowest residual in its first {BENCH_STEPS} "
          f"steps {ref_min!r}", flush=True)
    if ref["converged"]:
        check(info.converged, f"the solve did not converge to {TOL_ABS} "
              f"in {info.steps} steps; the JAX package's did")
    else:
        print(f"bench solve: not converged to {TOL_ABS} in {info.steps} "
              "steps, nor is the JAX package's", flush=True)
        check(ref_min / 10 <= min(res) <= 10 * ref_min,
              f"lowest residual {min(res)!r} is not within 10x of the JAX "
              f"package's {ref_min!r} over its first {BENCH_STEPS} steps")
    check(u.shape == (cm.NC, 4) and u.dtype == torch.float64
          and bool(torch.isfinite(u).all()), "non-finite solution")
    check(all(np.isfinite(r) for r in res), "non-finite accepted residual")
    its = info.total_lin_iters
    check(its > 0 and launches["banded_apply"] >= its
          and launches["banded_bsgs"] >= its,
          f"kernel launches {launches} for {its} Krylov iterations")
    return cm


def bench_first_order(dev, cm):
    """The first-order (starter) form of the bench solve converges."""
    import torch
    from fvens_tpu_torch.cases.bench_case import MAX_STEPS, TOL_ABS, run_solve

    solve1, _ = run_solve(dev, order2=False)
    zero_counts()
    t0 = time.perf_counter()
    u1, info1 = solve1(max_steps=MAX_STEPS)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    launches1 = read_counts()
    ref1 = jax_record(order2=False, mixed=True)
    print("first-order solve", json.dumps(dict(
        converged=info1.converged, steps=info1.steps,
        krylov_iters=info1.total_lin_iters, wall_s=wall1,
        cell_updates_per_s=cm.n_cells * info1.steps / wall1,
        launches=launches1, final_res=info1.finalres,
        jax_cpu_steps=ref1["steps"],
        jax_cpu_krylov_iters=ref1["krylov_iters"])), flush=True)
    check(info1.converged and info1.finalres <= TOL_ABS
          and bool(torch.isfinite(u1).all()),
          "the first-order solve did not converge")
    check(ref1["converged"] and info1.steps == ref1["steps"]
          and abs(info1.total_lin_iters - ref1["krylov_iters"])
          <= 0.02 * ref1["krylov_iters"],
          "the first-order solve departs from the JAX package's")
    its1 = info1.total_lin_iters
    check(launches1["banded_apply"] >= its1
          and launches1["banded_bsgs"] >= its1,
          f"kernel launches {launches1} for {its1} Krylov iterations in the "
          "first-order solve")


def bench_twins(dev, cm):
    """The bench's first steps through the kernel and through the twins."""
    from fvens_tpu_torch.cases.bench_case import bench_solver
    from fvens_tpu_torch.cases.casesolvers import initial_state

    for mixed, nsteps, ncompare in ((False, 3, 3), (True, 2, 1)):
        hist = {}
        for pallas in (True, False):
            s, _ = bench_solver(dev, mixed=mixed, pallas=pallas)
            hist[pallas] = s.solve(cm, initial_state(s.space, cm),
                                   max_steps=nsteps)[1].history
        for k in range(nsteps):
            a, b = hist[True][k], hist[False][k]
            rel = abs(a[2] - b[2]) / abs(b[2])
            print(f"twin step {k + 1} mixed={mixed}: iters {a[4]} vs "
                  f"{b[4]}, res {a[2]!r} vs {b[2]!r} (rel {rel:.3e})",
                  flush=True)
            check(rel <= 1e-4, f"residuals differ at step {k + 1}")
            if k < ncompare:
                check(a[4] == b[4], f"Krylov iterations differ at step "
                      f"{k + 1}")


def small_history(dev, case: dict):
    """Per-step history of one of SMALL_CASES on `dev`, through the
    kernel."""
    import dataclasses
    from fvens_tpu_torch.cases.bench_case import bench_solver
    from fvens_tpu_torch.cases.casesolvers import initial_state

    solver, cm = bench_solver(dev, mesh=SMALL_MESH, mixed=case["mixed"],
                              order2=case["order2"], **case.get("lin", {}))
    solver.cfg = dataclasses.replace(solver.cfg, cfl_init=case["cfl"][0],
                                     cfl_fin=case["cfl"][1])
    return solver.solve(cm, initial_state(solver.space, cm),
                        max_steps=len(case["ref"]))[1].history


def small_solves(dev):
    for case in SMALL_CASES + GATHER_SMALL_CASES:
        ref = case["ref"]
        hist = small_history(dev, case)
        name = (f"order2={case['order2']} mixed={case['mixed']} "
                f"{case.get('lin', 'banded bsgs')}")
        check(len(hist) == len(ref), f"small solve {name} ran {len(hist)} "
              f"steps, not {len(ref)}")
        for k, ((res_ref, it_ref), h) in enumerate(zip(ref, hist)):
            err = abs(h[2] - res_ref)
            print(f"reference {name} step {k + 1}: iters {h[4]} vs {it_ref}, "
                  f"res {h[2]!r} vs {res_ref!r} (abs {err:.3e})", flush=True)
            check(abs(h[4] - it_ref) <= case["iters"]
                  and err <= case["res"] * max(res_ref, ref[0][0]),
                  f"small solve {name} departs from the JAX package at "
                  f"step {k + 1}")


def write_cylinder_msh(path: str, ni: int, nj: int):
    """cylinder_omesh(ni, nj, stretch=1.15**(20/nj)) as a Gmsh 2 file."""
    from fvens_tpu_torch.cases.convertformat import write_gmsh2
    from fvens_tpu_torch.mesh.meshgen import cylinder_omesh
    write_gmsh2(path, cylinder_omesh(ni, nj, stretch=1.15 ** (20.0 / nj)))


def parse_cli_output(text: str) -> dict:
    """What the CLI (either package's) printed: whether it resumed, how
    many steps it retried after a blowup or NaN (their Krylov iterations
    are in no monitor line), the starter's Krylov iterations per step (its
    monitor lines, labelled BE; all of them with --log_every 1), the main
    solve's steps and Krylov iterations, and the functionals."""
    import re
    out = dict(resumed="resumed from" in text,
               retries=len(re.findall(r"retrying from", text)),
               starter_iters=[int(m.group(1)) for m in re.finditer(
                   r"^\s*BE \|\s+\d+ \|[^|]+\|[^|]+\|\s+(\d+) \|", text,
                   re.M)])
    m = re.search(r"solved in (\d+) steps, (\d+) linear iterations", text)
    if m:
        out.update(main_steps=int(m.group(1)), main_iters=int(m.group(2)))
    for k, pat in zip(FUNCTIONALS, ("entropy error", "CL", "CDp", "CDsf")):
        m = re.search(rf"^\s*{pat}\s*[:=]\s*(\S+)", text, re.M)
        if m:
            out[k] = float(m.group(1))
    return out


def run_cli(argv: list, log: str) -> dict:
    """fvens_tpu_torch.cases.cli.main(argv) in this process, its standard
    output captured into CLI_LOG_DIR/`log`. Returns the exit code (or
    "ToleranceError" where the solve stopped unconverged), the wall time
    and parse_cli_output of what it printed."""
    import io
    from fvens_tpu_torch.cases import cli
    from fvens_tpu_torch.solver.steady import ToleranceError

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    except ToleranceError:
        # the solver's verdict on a run that stopped unconverged, as the
        # JAX package's CLI raises it; the caller decides
        rc = "ToleranceError"
    finally:
        text = buf.getvalue()
        os.makedirs(CLI_LOG_DIR, exist_ok=True)
        with open(os.path.join(CLI_LOG_DIR, log), "w") as f:
            f.write(text)
    return dict(rc=rc, wall_s=time.perf_counter() - t0,
                **parse_cli_output(text))


def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def same_functionals(a: dict, b: dict, rtol: float,
                     cl_abs: float = 1e-12) -> bool:
    """entropy, CL, CDp and CDsf of a within rtol of b's; CL is zero by
    the case's symmetry (its value is rounding), so it is held to an
    absolute cl_abs where that is larger."""
    return all(abs(a[k] - b[k]) <= max(rtol * abs(b[k]),
                                       cl_abs if k == "CL" else 1e-12)
               for k in FUNCTIONALS)


def cli_path(dev):
    """The control-file entry point at CLI_MESH on the card, counted: the
    committed ctrl and solverc with every output, then the same command
    again, which must resume from the checkpoint. Returns (report,
    launches of the first run)."""
    import tempfile
    import xml.etree.ElementTree as ET
    import torch
    from fvens_tpu_torch.io_config import parse_control_file

    tol = parse_control_file(CLI_CTRL).main.tol
    ni, nj = CLI_MESH
    with tempfile.TemporaryDirectory() as tmp:
        p = {k: os.path.join(tmp, f) for k, f in (
            ("msh", "cylinder.msh"), ("vtu", "cylinder.vtu"),
            ("surface", "surface.dat"), ("history", "history.jsonl"),
            ("history2", "history2.jsonl"), ("checkpoint", "ck.npz"))}
        t0 = time.perf_counter()
        write_cylinder_msh(p["msh"], ni, nj)
        mesh_s = time.perf_counter() - t0
        base = [CLI_CTRL, "--mesh_file", p["msh"], "-options_file",
                CLI_SOLVERC, "--device", dev.type, "--checkpoint",
                p["checkpoint"], "--functionals_every",
                str(CLI_FUNCTIONALS_EVERY), "--log_every", "1"]
        torch.cuda.synchronize()
        zero_counts()
        run = run_cli(base + ["--vtu", p["vtu"], "--surface", p["surface"],
                              "--history", p["history"]],
                      f"cli_{ni}x{nj}.log")
        torch.cuda.synchronize()
        launches = read_counts()
        check(run["rc"] == 0, f"the CLI exited {run['rc']}")
        rows = read_jsonl(p["history"])
        its = sum(run["starter_iters"]) + sum(r["lin_iters"] for r in rows)
        check(not run["resumed"], "the first CLI run resumed")
        check([r["step"] for r in rows] == list(range(1, len(rows) + 1))
              and len(rows) == run["main_steps"]
              and sum(r["lin_iters"] for r in rows) == run["main_iters"],
              "the history does not hold one line per main step")
        check(rows[-1]["relres"] <= tol,
              f"the CLI solve stopped at {rows[-1]['relres']!r}, not {tol}")
        check(its > 0 and launches["row_set"] == its,
              f"{launches['row_set']} row_set launches for {its} Krylov "
              "iterations (starter and main)")
        check(launches["banded_apply"] == launches["banded_bsgs"] == 0,
              f"the CLI launched a banded kernel: {launches}")
        logged = [r for r in rows if "CL" in r]
        check([r["step"] for r in logged]
              == [r["step"] for r in rows
                  if r["step"] % CLI_FUNCTIONALS_EVERY == 0] and logged
              and all(np.isfinite(r[k]) for r in logged
                      for k in FUNCTIONALS),
              "functionals not logged every "
              f"{CLI_FUNCTIONALS_EVERY} steps, or not finite")
        check(all(np.isfinite(run[k]) for k in FUNCTIONALS),
              f"non-finite functionals {run}")
        piece = ET.parse(p["vtu"]).getroot().find("UnstructuredGrid/Piece")
        dens = next(a for a in piece.iter("DataArray")
                    if a.get("Name") == "density").text.split()
        check(int(piece.get("NumberOfCells")) == ni * nj
              and len(dens) == ni * nj
              and bool(np.isfinite(np.asarray(dens, float)).all()),
              "the VTU does not hold the mesh's cells")
        surf = np.loadtxt(p["surface"])
        check(surf.shape == (CLI_WALL_FACES, 4)
              and bool(np.isfinite(surf).all()),
              f"surface table of shape {surf.shape}")
        vtu_mb = os.path.getsize(p["vtu"]) / 1e6

        run2 = run_cli(base + ["--history", p["history2"]],
                       f"cli_{ni}x{nj}_resume.log")
        rows2 = read_jsonl(p["history2"])
    check(run2["rc"] == 0 and run2["resumed"],
          "the second CLI run did not resume from the checkpoint")
    check(same_functionals(run2, run, 1e-8),
          f"the resumed run's functionals {run2} differ from {run}")
    main_s = rows[-1]["wall_s"] - rows[0]["wall_s"]
    rep = dict(
        mesh=f"cylinder_omesh{CLI_MESH}", cells=ni * nj, dtype="float64",
        mesh_write_s=mesh_s, wall_s=run["wall_s"],
        starter_steps=len(run["starter_iters"]),
        starter_krylov_iters=sum(run["starter_iters"]),
        main_steps=run["main_steps"], main_krylov_iters=run["main_iters"],
        main_s_per_step=main_s / max(len(rows) - 1, 1),
        final_relres=rows[-1]["relres"], vtu_mb=vtu_mb,
        functionals={k: run[k] for k in FUNCTIONALS},
        resumed_at=min(r["step"] for r in rows2) - 1 if rows2 else None,
        resumed_steps=len(rows2), resumed_wall_s=run2["wall_s"],
        resumed_functionals_bitwise=all(run2[k] == run[k]
                                        for k in FUNCTIONALS),
        launches=launches)
    print("cli", json.dumps(rep), flush=True)
    return rep, launches


def cli_vs_record(dev):
    """The CLI at CHECK_MESH on the card against the JAX package's CLI on
    the same files (JAX_CLI_RECORD): the starter's steps exactly, the first
    AGREE_STEPS main steps step for step (Krylov iterations within 1,
    residuals within 1%), the main steps and Krylov iterations within 10%,
    and the converged functionals within 1e-6."""
    import tempfile

    rec = _load(JAX_CLI_RECORD)
    ni, nj = CHECK_MESH
    with tempfile.TemporaryDirectory() as tmp:
        msh = os.path.join(tmp, "cylinder.msh")
        hist = os.path.join(tmp, "history.jsonl")
        write_cylinder_msh(msh, ni, nj)
        run = run_cli([CLI_CTRL, "--mesh_file", msh, "-options_file",
                       CLI_SOLVERC, "--device", dev.type, "--log_every", "1",
                       "--functionals_every", str(CLI_FUNCTIONALS_EVERY),
                       "--history", hist], f"cli_{ni}x{nj}.log")
        rows = read_jsonl(hist) if run["rc"] == 0 else []
    check(run["rc"] == 0, f"the {ni}x{nj} CLI run exited {run['rc']}")
    ref = rec["main"]
    print(f"cli {ni}x{nj}: starter {len(run['starter_iters'])} steps / "
          f"{sum(run['starter_iters'])} iterations, main {run['main_steps']}"
          f" / {run['main_iters']}, functionals "
          f"{json.dumps({k: run[k] for k in FUNCTIONALS})}; the JAX "
          f"package's: starter {rec['starter']['steps']} / "
          f"{rec['starter']['krylov_iters']}, main {ref['steps']} / "
          f"{ref['krylov_iters']}, {json.dumps(rec['functionals'])}",
          flush=True)
    check(len(run["starter_iters"]) == rec["starter"]["steps"],
          "the starter departs from the JAX package's")
    check(len(rows) >= AGREE_STEPS,
          f"the main solve took only {len(rows)} steps")
    for r, q in zip(rows[:AGREE_STEPS], ref["history"]):
        check(abs(r["lin_iters"] - q["lin_iters"]) <= 1
              and abs(r["absres"] - q["absres"]) <= 0.01 * q["absres"],
              f"main step {r['step']}: iterations {r['lin_iters']} vs "
              f"{q['lin_iters']}, residual {r['absres']!r} vs "
              f"{q['absres']!r}")
    for got, key in ((run["main_steps"], "steps"),
                     (run["main_iters"], "krylov_iters")):
        check(abs(got - ref[key]) <= 0.1 * ref[key],
              f"main {key} {got} not within 10% of the JAX package's "
              f"{ref[key]}")
    check(same_functionals(run, rec["functionals"], 1e-6),
          "the functionals differ from the JAX package's by more than 1e-6")
    return {k: run[k] for k in FUNCTIONALS}


def card_line(kind: str, rec: dict):
    """One path's record on a line of its own, with the card it ran on."""
    print(kind, json.dumps(dict(rec, card=CARD)), flush=True)


def sweep_config(flux="HLLC", gradient="LEASTSQUARES", reconstruction="LINEAR",
                 flux_jacobian="CONSISTENT"):
    """The cylinder case's physics with other numerics (WENO at lambda = 0
    as every reference run has it, Venkatakrishnan at K = 20)."""
    import dataclasses
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.config import NumericsConfig
    return dataclasses.replace(
        bigmesh_case.case_config(), numerics=NumericsConfig(
            flux=flux, flux_jacobian=flux_jacobian, gradient=gradient,
            reconstruction=reconstruction,
            limiter_param=SWEEP_LIMITER_PARAM.get(reconstruction, 20.0)))


def sweep_meshes(dev, ni, nj):
    """(card mesh, CPU copy, card state, CPU state): cylinder_omesh(ni, nj)
    at f64 and the free stream times (1 + 0.01 N(0, 1)) from SWEEP_SEED."""
    import torch
    from fvens_tpu_torch.cases.casesolvers import build_space
    from fvens_tpu_torch.mesh.device_mesh import compile_mesh
    from fvens_tpu_torch.mesh.meshgen import cylinder_omesh
    cfg = sweep_config()
    md = cylinder_omesh(ni, nj, stretch=1.15 ** (20.0 / nj))
    gm = compile_mesh(md, cfg.bcs, dtype=torch.float64, device=dev)
    cm = gm.to(device="cpu")
    uinf = build_space(cfg).uinf(torch.float64, "cpu").numpy()
    rng = np.random.default_rng(SWEEP_SEED)
    u = np.tile(uinf, (cm.NC, 1)) * (1.0 + 0.01 * rng.standard_normal(
        (cm.NC, 4)))
    uc = torch.from_numpy(u)
    return gm, cm, uc.to(dev), uc


def rel_err(a, b) -> float:
    """max |a - b| over max |b|, a on the card, b on the CPU."""
    return float((a.cpu() - b).abs().max() / b.abs().max())


def scheme_sweep(dev):
    """Phase A: every flux, gradient scheme and reconstruction on the card
    at SWEEP_MESH, each residual held to the port's CPU residual of the
    same tensors (1e-12) and timed (CUDA events); each flux's slot
    Jacobian, CONSISTENT and FROZEN, held to the CPU at SWEEP_JAC_CHECK
    (1e-11) and timed at SWEEP_MESH. Returns the rows."""
    from fvens_tpu_torch.cases.casesolvers import build_space
    gm, cm, ug, uc = sweep_meshes(dev, *SWEEP_MESH)
    rows = []
    for flux, grad, recon in SWEEP_COMBOS:
        space = build_space(sweep_config(flux, grad, recon))
        rg, dg = space.compute_residual(gm, ug, True)
        rc, dc = space.compute_residual(cm, uc, True)
        row = dict(what="residual", flux=flux, gradient=grad,
                   reconstruction=recon, cells=gm.n_cells,
                   rhs_rel_err=rel_err(rg, rc), dt_rel_err=rel_err(dg, dc))
        check(bool(rg.isfinite().all()) and row["rhs_rel_err"] <= 1e-12
              and row["dt_rel_err"] <= 1e-12,
              f"the card's residual departs from the CPU's: {row}")
        row["ms"] = event_ms(lambda: space.compute_residual(gm, ug, True),
                             SWEEP_RUNS)
        rows.append(row)
        print("scheme sweep", json.dumps(row), flush=True)
    jg, jc, jug, juc = sweep_meshes(dev, *SWEEP_JAC_CHECK)
    for flux in SWEEP_FLUXES:
        for mode in ("CONSISTENT", "FROZEN"):
            space = build_space(sweep_config(flux, flux_jacobian=mode))
            a, b = space.assemble_jacobian(jg, jug), space.assemble_jacobian(
                jc, juc)
            row = dict(what="jacobian", flux=flux, flux_jacobian=mode,
                       cells=gm.n_cells, check_cells=jg.n_cells,
                       D_rel_err=rel_err(a.D, b.D),
                       N_rel_err=rel_err(a.N, b.N))
            check(row["D_rel_err"] <= 1e-11 and row["N_rel_err"] <= 1e-11,
                  f"the card's Jacobian departs from the CPU's: {row}")
            row["ms"] = event_ms(lambda: space.assemble_jacobian(gm, ug),
                                 SWEEP_JAC_RUNS)
            rows.append(row)
            print("scheme sweep", json.dumps(row), flush=True)
    print(f"scheme sweep at cylinder_omesh{SWEEP_MESH}, f64, card {CARD}:")
    print("  | what | flux | gradient / Jacobian | reconstruction | ms |")
    for r in rows:
        print(f"  | {r['what']} | {r['flux']} | "
              f"{r.get('gradient', r.get('flux_jacobian'))} | "
              f"{r.get('reconstruction', '')} | {r['ms']:.4f} |", flush=True)
    return rows


def record_part(part: str) -> dict:
    return _load(JAX_SCHEMES_RECORD)[part]


def capped_ctrl(src: str, path: str, subs: dict) -> str:
    """Writes the ctrl `src` to `path` with each `old: new` replaced."""
    with open(src) as f:
        text = f.read()
    for old, new in subs.items():
        check(old in text, f"{src} has no '{old}'")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return path


def naca_cli_path(dev):
    """Phase B1: the CLI on the transonic NACA0012 ctrl at NACA_MESH, f64
    on the gather path (blocked GMRES, row_set on every Krylov iteration),
    with the main solve capped at NACA_MAIN_STEPS. A relative residual
    falls more slowly on the finer mesh (at main step 150, 3.2e-2 at
    640x320 against 1.3e-3 at 160x80 on the card), so the run is not held
    to the JAX record's level (at NACA_CHECK_MESH; printed beside it) but
    to the card's own: it must stop at the cap with no retried step, its
    relative residual within a factor NACA_TRACK of NACA_CARD_RELRES at
    each of those steps and at most NACA_LEVEL at the cap. Returns the
    launches."""
    import tempfile
    import torch
    from fvens_tpu_torch.cases.convertformat import write_gmsh2
    from fvens_tpu_torch.mesh.meshgen import naca0012_omesh
    rec = record_part("naca")
    ni, nj = NACA_MESH
    with tempfile.TemporaryDirectory() as tmp:
        msh = os.path.join(tmp, "naca.msh")
        write_gmsh2(msh, naca0012_omesh(ni, nj))
        hist = os.path.join(tmp, "history.jsonl")
        ctrl = capped_ctrl(NACA_CTRL, os.path.join(tmp, "capped.ctrl"), {
            "max_timesteps  5000": f"max_timesteps  {NACA_MAIN_STEPS}"})
        torch.cuda.synchronize()
        zero_counts()
        run = run_cli([ctrl, "--mesh_file", msh, "-options_file",
                       NACA_SOLVERC, "--device", dev.type, "--log_every",
                       "1", "--functionals_every", str(CLI_FUNCTIONALS_EVERY),
                       "--history", hist], f"cli_naca_{ni}x{nj}.log")
        torch.cuda.synchronize()
        launches = read_counts()
        rows = read_jsonl(hist)
    check(run["rc"] == "ToleranceError" and len(rows) == NACA_MAIN_STEPS,
          f"the CLI exited {run['rc']} after {len(rows)} main steps; it "
          f"should stop at the cap of {NACA_MAIN_STEPS}")
    main_its = sum(r["lin_iters"] for r in rows)
    its = sum(run["starter_iters"]) + main_its
    rel = [r["relres"] for r in rows]
    logged = [r for r in rows if "CL" in r]
    rep = dict(mesh=f"naca0012_omesh{NACA_MESH}", cells=ni * nj,
               exit=run["rc"], wall_s=run["wall_s"],
               starter_steps=len(run["starter_iters"]),
               starter_krylov_iters=sum(run["starter_iters"]),
               main_steps=len(rows), main_krylov_iters=main_its,
               main_s_per_step=(rows[-1]["wall_s"] - rows[0]["wall_s"])
               / max(len(rows) - 1, 1), retries=run["retries"],
               min_relres=min(rel), final_relres=rel[-1],
               relres_at={s: rel[s - 1] for s in NACA_CARD_RELRES
                          if s <= len(rel)},
               functionals=({k: logged[-1][k] for k in ("step",)
                             + FUNCTIONALS} if logged else None),
               record=dict(converged=rec["converged"],
                           min_relres=rec["main"]["min_relres"],
                           main_steps=rec["main"]["steps"]),
               launches=launches)
    card_line("naca cli", rep)
    # a retried step's Krylov iterations launch row_set too, and no
    # monitor line or history row counts them
    check(its > 0 and (launches["row_set"] == its if not run["retries"]
                       else launches["row_set"] > its),
          f"{launches['row_set']} row_set launches for {its} Krylov "
          f"iterations (starter and main) and {run['retries']} retries")
    check(launches["banded_apply"] == launches["banded_bsgs"] == 0,
          f"the CLI launched a banded kernel: {launches}")
    check(all(np.isfinite(r["absres"]) for r in rows) and logged
          and all(np.isfinite(r[k]) for r in logged for k in FUNCTIONALS),
          "non-finite residuals or functionals")
    off = {s: rel[s - 1] for s, want in NACA_CARD_RELRES.items()
           if s <= len(rel)
           and not want / NACA_TRACK <= rel[s - 1] <= want * NACA_TRACK}
    check(not run["retries"] and not off and rel[-1] <= NACA_LEVEL,
          f"{run['retries']} retries; relative residuals {off} not within "
          f"{NACA_TRACK}x of {NACA_CARD_RELRES}; {rel[-1]!r} at the cap "
          f"(at most {NACA_LEVEL})")
    return launches


def naca_cli_vs_record(dev):
    """Phase B1 at NACA_CHECK_MESH: the CLI, its main solve capped at
    NACA_CHECK_MAIN_STEPS, against the JAX package's CLI on the same files
    (JAX_SCHEMES_RECORD, which converged in 1,788 main steps): the starter
    step for step (Krylov iterations), the first NACA_AGREE_STEPS main
    steps step for step (iterations, residuals to 1e-9 relative with a
    floor of 1e-12 of the first main residual), the stop at the cap, and
    the relative residual within a factor NACA_TRACK of the record's at
    each NACA_CHECK_AT step."""
    import tempfile
    rec = record_part("naca")
    ni, nj = NACA_CHECK_MESH
    from fvens_tpu_torch.cases.convertformat import write_gmsh2
    from fvens_tpu_torch.mesh.meshgen import naca0012_omesh
    with tempfile.TemporaryDirectory() as tmp:
        msh = os.path.join(tmp, "naca.msh")
        write_gmsh2(msh, naca0012_omesh(ni, nj))
        hist = os.path.join(tmp, "history.jsonl")
        ctrl = capped_ctrl(NACA_CTRL, os.path.join(tmp, "capped.ctrl"), {
            "max_timesteps  5000":
            f"max_timesteps  {NACA_CHECK_MAIN_STEPS}"})
        run = run_cli([ctrl, "--mesh_file", msh, "-options_file",
                       NACA_SOLVERC, "--device", dev.type, "--log_every",
                       "1", "--history", hist], f"cli_naca_{ni}x{nj}.log")
        rows = read_jsonl(hist)
    ref = rec["main"]
    print(f"naca cli {ni}x{nj}: exit {run['rc']}, starter "
          f"{len(run['starter_iters'])} / {sum(run['starter_iters'])}, main "
          f"{len(rows)} / {sum(r['lin_iters'] for r in rows)}, lowest "
          f"{min(r['relres'] for r in rows)!r}; the JAX package's: exit "
          f"{rec['exit']}, starter {rec['starter']['steps']} / "
          f"{rec['starter']['krylov_iters']}, main {ref['steps']} / "
          f"{ref['krylov_iters']}, lowest {ref['min_relres']!r}", flush=True)
    check(rec["converged"]
          and ref["steps"] > NACA_CHECK_MAIN_STEPS >= max(NACA_CHECK_AT),
          "the record does not run past the cap")
    check(run["rc"] == "ToleranceError" and len(rows)
          == NACA_CHECK_MAIN_STEPS,
          f"the {ni}x{nj} run exited {run['rc']} after {len(rows)} main "
          f"steps; it should stop at the cap of {NACA_CHECK_MAIN_STEPS}")
    check(run["starter_iters"] == rec["starter"]["lin_iters"],
          "the starter departs from the JAX package's")
    floor = 1e-12 * ref["history"][0]["absres"]
    for r, q in zip(rows[:NACA_AGREE_STEPS], ref["history"]):
        check(r["lin_iters"] == q["lin_iters"]
              and abs(r["absres"] - q["absres"])
              <= max(1e-9 * q["absres"], floor),
              f"main step {r['step']}: iterations {r['lin_iters']} vs "
              f"{q['lin_iters']}, residual {r['absres']!r} vs "
              f"{q['absres']!r}")
    for s in NACA_CHECK_AT:
        got, want = rows[s - 1]["relres"], ref["history"][s - 1]["relres"]
        check(want / NACA_TRACK <= got <= want * NACA_TRACK,
              f"main step {s}: relative residual {got!r} not within "
              f"{NACA_TRACK}x of the record's {want!r}")


def limited_banded_path(dev):
    """Phase B2: the banded cylinder case at BIGMESH with Venkatakrishnan
    (K = 20), mixed precision: the starter, then LIMITED_MAIN_STEPS main
    steps through K1, K1b and K2; finite, falling residuals. Returns the
    launches."""
    import dataclasses
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.cases.casesolvers import SteadyFlowCase, build_space
    _, cm, u = bigmesh_case.build_case(dev, *bigmesh_case.BIGMESH)
    cfg = dataclasses.replace(
        bigmesh_case.case_config(), numerics=dataclasses.replace(
            bigmesh_case.case_config().numerics,
            reconstruction="VENKATAKRISHNAN", limiter_param=20.0))
    case = SteadyFlowCase(cfg)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    u = case.execute_starter(cm, u)
    solver = case._make_solver(build_space(cfg), cfg.main)
    tm = time.perf_counter()
    u, info = solver.solve(cm, u, max_steps=LIMITED_MAIN_STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_counts()
    st = case.starter_info
    res = [h[2] for h in info.history]
    its = st.total_lin_iters + info.total_lin_iters
    card_line("limited banded", dict(
        mesh=f"cylinder_omesh{bigmesh_case.BIGMESH}", cells=cm.n_cells,
        reconstruction="VENKATAKRISHNAN", limiter_param=20.0,
        starter_steps=st.steps, starter_krylov_iters=st.total_lin_iters,
        main_steps=info.steps, main_krylov_iters=info.total_lin_iters,
        wall_s=t1 - t0, main_s_per_step=(t1 - tm) / max(info.steps, 1),
        cell_updates_per_s=cm.n_cells * info.steps / (t1 - tm),
        residuals=res, launches=launches))
    check(info.steps == LIMITED_MAIN_STEPS and bool(torch.isfinite(u).all())
          and all(np.isfinite(r) for r in res),
          f"the limited run took {info.steps} steps or went non-finite")
    check(res[-1] < res[0], f"the limited main residual did not fall: {res}")
    check(launches["row_set"] == its and its > 0
          and launches["banded_bsgs"] >= its
          and its <= launches["banded_apply"] < 2 * its,
          f"limited launches {launches} for {its} Krylov iterations")
    return launches


def explicit_cli_path(dev):
    """Phase C: the CLI on cylinder-explicit.ctrl at EXPLICIT_MESH, to the
    relative residual the JAX record reaches at 160x80 (the ctrl's
    tolerance) or EXPLICIT_MAX_STEPS steps; then at EXPLICIT_CHECK_MESH its
    first EXPLICIT_AGREE_STEPS steps against the record's to 1e-10
    relative. No kernel launches (no Krylov solve). Returns the launches."""
    import tempfile
    import torch
    rec = record_part("explicit")
    ni, nj = EXPLICIT_MESH
    with tempfile.TemporaryDirectory() as tmp:
        msh = os.path.join(tmp, "cyl.msh")
        write_cylinder_msh(msh, ni, nj)
        hist = os.path.join(tmp, "history.jsonl")
        ctrl = capped_ctrl(EXPLICIT_CTRL, os.path.join(tmp, "full.ctrl"), {
            "max_timesteps  100000": f"max_timesteps  {EXPLICIT_MAX_STEPS}"})
        torch.cuda.synchronize()
        zero_counts()
        run = run_cli([ctrl, "--mesh_file", msh, "--device", dev.type,
                       "--log_every", "1000", "--history", hist],
                      f"cli_explicit_{ni}x{nj}.log")
        torch.cuda.synchronize()
        launches = read_counts()
        rows = read_jsonl(hist)
        ci, cj = EXPLICIT_CHECK_MESH
        msh2 = os.path.join(tmp, "cyl2.msh")
        write_cylinder_msh(msh2, ci, cj)
        hist2 = os.path.join(tmp, "history2.jsonl")
        ctrl2 = capped_ctrl(EXPLICIT_CTRL, os.path.join(tmp, "first.ctrl"), {
            "max_timesteps  100000":
            f"max_timesteps  {EXPLICIT_AGREE_STEPS}"})
        run2 = run_cli([ctrl2, "--mesh_file", msh2, "--device", dev.type,
                        "--log_every", "0", "--history", hist2],
                       f"cli_explicit_{ci}x{cj}.log")
        rows2 = read_jsonl(hist2)
    steps = len(rows)
    main_s = rows[-1]["wall_s"] - rows[0]["wall_s"]
    rep = dict(mesh=f"cylinder_omesh{EXPLICIT_MESH}", cells=ni * nj,
               exit=run["rc"], wall_s=run["wall_s"], steps=steps,
               tolerance=rec["full"]["final_relres"],
               final_relres=rows[-1]["relres"],
               steps_per_s=(steps - 1) / main_s,
               cell_updates_per_s=ni * nj * (steps - 1) / main_s,
               record_160x80_steps=rec["full"]["steps"], launches=launches)
    card_line("explicit cli", rep)
    check(run["rc"] in (0, "ToleranceError")
          and all(np.isfinite(r["absres"]) for r in rows),
          f"the explicit CLI run exited {run['rc']} or went non-finite")
    check(run["rc"] == 0 or steps == EXPLICIT_MAX_STEPS,
          f"the run stopped after {steps} steps")
    check(all(n == 0 for n in launches.values()),
          f"the explicit run launched a kernel: {launches}")
    ref = rec["first"]["history"]
    check(run2["rc"] == "ToleranceError" and len(rows2) == len(ref),
          f"the {EXPLICIT_CHECK_MESH} run took {len(rows2)} steps")
    worst = max(abs(r["absres"] - q["absres"]) / q["absres"]
                for r, q in zip(rows2, ref))
    print(f"explicit cli {EXPLICIT_CHECK_MESH}: {len(rows2)} steps, worst "
          f"relative residual difference from the record {worst:.3e}",
          flush=True)
    check(worst <= 1e-10, "the explicit run departs from the JAX package's")
    card_line("explicit read-back", explicit_readback_cost(dev))
    return launches


def explicit_readback_cost(dev, steps=EXPLICIT_READBACK_STEPS) -> dict:
    """What SteadyForwardEuler's one residual read-back per step costs at
    EXPLICIT_MESH: `steps` steps with .item() after each (the solver's
    loop), and the same steps queued with one synchronize at the end."""
    import torch
    from fvens_tpu_torch.cases.casesolvers import build_space, initial_state
    from fvens_tpu_torch.io_config import parse_control_file
    from fvens_tpu_torch.mesh.device_mesh import compile_mesh
    from fvens_tpu_torch.mesh.meshgen import cylinder_omesh
    from fvens_tpu_torch.solver.steady import SteadyForwardEuler
    cfg = parse_control_file(EXPLICIT_CTRL)
    ni, nj = EXPLICIT_MESH
    mesh = compile_mesh(cylinder_omesh(ni, nj, stretch=1.15 ** (20.0 / nj)),
                        cfg.bcs, dtype=torch.float64, device=dev)
    solver = SteadyForwardEuler(build_space(cfg), cfg.main)
    out = {}
    for name in ("read_back", "queued", "read_back_again"):
        u = initial_state(solver.space, mesh)
        solver._step(mesh, u)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            u, res = solver._step(mesh, u)
            if name != "queued":
                res.item()
        torch.cuda.synchronize()
        out[f"{name}_ms_per_step"] = (time.perf_counter() - t0) / steps * 1e3
    return dict(mesh=f"cylinder_omesh{EXPLICIT_MESH}", steps=steps, **out)


def vortex_path(dev):
    """Phase D: TVD-RK3 at CFL 0.8 on the VORTEX_N periodic vortex box to
    VORTEX_T (Roe, least squares, LINEAR): mass conserved to 1e-10, the L2
    density error under half the vortex's own deviation and at least 4x
    below the VORTEX_COARSE run's; at 64x64 to t = 0.5 the record's step
    count, t to 1e-12 and state to 1e-10. Returns the launches."""
    import base64
    import torch
    from fvens_tpu_torch.cases import model_problems as mp
    from fvens_tpu_torch.solver.unsteady import TVDRKSolver
    rec = record_part("vortex")
    n, t_end = rec["case"]["n"], rec["case"]["final_time"]
    space, mesh, u0 = mp.vortex_case(dev, n)
    u, t, steps = TVDRKSolver(space, order=3, cfl=0.8).solve(mesh, u0, t_end)
    want = np.frombuffer(base64.b64decode(rec["state_f64_base64"]),
                         dtype="<f8").reshape(rec["state_shape"])
    err = float(np.abs(u.cpu().numpy() - want).max() / np.abs(want).max())
    print(f"vortex {n}x{n} to t={t_end}: {steps} steps (record "
          f"{rec['steps']}), t {t!r}, state relative difference {err:.3e}",
          flush=True)
    check(steps == rec["steps"] and abs(t - rec["t"]) <= 1e-12
          and err <= 1e-10, "the 64x64 vortex departs from the JAX record")
    out = {}
    for n in (VORTEX_COARSE, VORTEX_N):
        space, mesh, u0 = mp.vortex_case(dev, n)
        solver = TVDRKSolver(space, order=3, cfl=0.8)
        torch.cuda.synchronize()
        if n == VORTEX_N:
            zero_counts()
        t0 = time.perf_counter()
        u, t, steps = solver.solve(mesh, u0, VORTEX_T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[n] = dict(n=n, cells=mesh.n_cells, steps=steps, t=t, wall_s=wall,
                      s_per_step=wall / steps,
                      cell_updates_per_s=mesh.n_cells * steps / wall,
                      finite=bool(torch.isfinite(u).all()),
                      **mp.vortex_errors(mesh, u0, u, t))
    launches = read_counts()
    fine, coarse = out[VORTEX_N], out[VORTEX_COARSE]
    card_line("vortex", dict(fine, coarse_l2_error=coarse["l2_error"],
                             coarse_steps=coarse["steps"],
                             launches=launches))
    check(fine["finite"] and abs(fine["t"] - VORTEX_T) <= 1e-12,
          "the vortex run went non-finite or missed its final time")
    check(abs(fine["mass"] - fine["mass0"]) <= 1e-10 * fine["mass0"],
          "mass not conserved")
    check(fine["l2_error"] < 0.5 * fine["l2_vortex"]
          and 4.0 * fine["l2_error"] <= coarse["l2_error"],
          f"vortex error {fine['l2_error']!r} (vortex {fine['l2_vortex']!r},"
          f" {VORTEX_COARSE}x{VORTEX_COARSE} {coarse['l2_error']!r})")
    check(all(v == 0 for v in launches.values()),
          f"the explicit vortex run launched a kernel: {launches}")
    return launches


def heat_solvers(dev, n: int):
    """make(mixed) -> (solver, mesh) of the banded heat problem on
    unit_square(n) (HEAT_BANDED), for banded_checks: one mesh for both."""
    import dataclasses
    from fvens_tpu_torch.cases import model_problems as mp
    solver, mesh = mp.heat_solver(dev, n, False, **HEAT_BANDED)
    return lambda mixed: (dataclasses.replace(solver, lin=dataclasses.replace(
        solver.lin, mixed_precision=mixed)), mesh)


def heat_state(mesh):
    """The heat problem's state of step 0: u = 0."""
    import torch
    return torch.zeros((mesh.NC, 1), dtype=torch.float64, device=mesh.device)


def heat_path(dev):
    """Phase E: DiffusionFV on unit_square(n) quads, implicit to 1e-9 at n
    in HEAT_N (V = 1 blocks), on the gather path (bcsgs x3) and banded
    (HEAT_BANDED: K1 for the matvec, K1b's cluster kernel for bsgs x6).
    At the largest, n = 262,144 and blocked GMRES launches row_set once
    per Krylov iteration. Each cycle of GMRES (one a step) is one K1
    launch for its residual and one per Krylov iteration; the cluster
    kernel one per Krylov iteration, and on the blocked path one more per
    cycle (its trailing apply); the cooperative bsgs kernel none. The
    banded runs take JAX_HEAT_BANDED_RECORD's steps, its Krylov
    iterations within 1 and its L2 error to 1e-8 relative. The L2
    error order between the two n must lie in [1.9, 2.1] on each path.
    Returns (the launches of the largest gather solve, of the largest
    banded one)."""
    import torch
    from fvens_tpu_torch.cases import model_problems as mp
    from fvens_tpu_torch.solver import linear
    rec = {r["n"]: r for r in _load(JAX_HEAT_BANDED_RECORD)["runs"]}
    errs, last = {}, {}
    for n in HEAT_N:
        for banded in (False, True):
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            err, info, mesh = mp.heat_solve(dev, n, False,
                                            **(HEAT_BANDED if banded else {}))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = last[banded] = read_counts()
            errs[n, banded] = err
            its, steps = info.total_lin_iters, info.steps
            blocked = mesh.NC >= linear._BLOCKED_N_THRESHOLD
            rep = dict(n=n, cells=mesh.n_cells, l2_error=err, steps=steps,
                       krylov_iters=its, converged=info.converged,
                       wall_s=wall, s_per_step=wall / max(steps, 1),
                       blocked=blocked, launches=launches)
            if banded:
                want = rec[n]
                rep["jax"] = dict(steps=want["steps"],
                                  krylov_iters=want["krylov_iters"],
                                  l2_error=want["l2_error"])
            card_line("heat banded" if banded else "heat", rep)
            check(info.converged and np.isfinite(err),
                  f"the heat solve at n = {n} (banded {banded}) did not "
                  "converge")
            # the bsgs apply at 1x1 blocks takes the cluster kernel, never
            # the cooperative one
            kernels = ((its + steps, 0, its + (steps if blocked else 0))
                       if banded else (0, 0, 0))
            check(launches["row_set"] == (its if blocked else 0)
                  and (launches["banded_apply"], launches["banded_bsgs"],
                       launches["banded_bsgs_cluster"]) == kernels,
                  f"heat launches {launches} for {its} Krylov iterations in "
                  f"{steps} steps (banded {banded}, blocked {blocked})")
            if banded:
                check(steps == want["steps"]
                      and abs(its - want["krylov_iters"]) <= 1
                      and abs(err - want["l2_error"])
                      <= 1e-8 * want["l2_error"],
                      f"banded heat at n = {n}: {steps} steps, {its} Krylov "
                      f"iterations, L2 error {err!r}; the JAX record's "
                      f"{rep['jax']}")
    a, b = HEAT_N[-2:]
    for banded in (False, True):
        order = float(np.log2(errs[a, banded] / errs[b, banded])
                      / np.log2(b / a))
        print(f"heat{' banded' if banded else ''} L2 error order between "
              f"n = {a} and {b}: {order:.4f}", flush=True)
        check(1.9 <= order <= 2.1,
              f"diffusion order {order} outside [1.9,2.1] (banded {banded})")
    check(rep["blocked"], "the largest heat solve did not run blocked")
    return last[False], last[True]


# Phase F: the JAX package's other solver options on the gather path
# (cases/bigmesh_case.OPTIONS) at OPTIONS_MESH, and at OPTIONS_CHECK_MESH
# against the JAX package's CPU runs of them (records/
# jax_solver_options_history.py).
JAX_OPTIONS_RECORD = "records/jax_solver_options_history.json"
OPTIONS_MESH = (640, 320)        # F1-F3: cylinder_omesh, 204,800 cells
ILU_MAIN_STEPS = 40              # F1: the ilu0 main solve's cap
OPTION_STEPS = 3                 # F2: main steps under each option but
JVP_STEPS = 2                    # the JVP's (5.0-5.6 s a step on an H100)
F2_OPTIONS = ("amg", "bline", "mf-jvp", "mf-fd")
AMG_REPEAT_STEPS = 3             # F2: amg steps run twice, bit for bit
RECYCLE_MAIN_STEPS = 60          # F3: the recycling main solve's cap
OPTIONS_CHECK_MESH = (160, 80)
# main steps run at OPTIONS_CHECK_MESH (None: to convergence) and held
# step for step to the record's classic run (Krylov iterations within 1,
# residuals within 1%) over the first OPTIONS_AGREE. The port's CPU runs
# part from the record where the Krylov solves stop at their 90-iteration
# cap and the trajectory turns chaotic: amg at main step 14, mf-jvp at 13,
# mf-fd at 11 (its relative gap grows about 3x a step from 1.2e-7), the
# GCRO-DR run at 16 (its recycled spaces); ilu0 and bline not within 60
# and 20 steps. The matrix-free runs are short here because a JVP matvec
# costs about 80 ms on the card (PERF.md).
OPTIONS_CHECK_STEPS = {"ilu0": 60, "amg": 16, "bline": 20, "mf-jvp": 6,
                       "mf-fd": 8, "bsgs-recycle": 20}
OPTIONS_AGREE = {"ilu0": 50, "amg": 12, "bline": 20, "mf-jvp": 6,
                 "mf-fd": 6, "bsgs-recycle": 12}
# the naca0012_omesh of phase B1, where lines of 32 cells form (the
# cylinder's near-square cells form none): the line smoother's apply timed
BLINE_NACA_MESH = (640, 320)


def option_solver(name: str):
    """(SteadyFlowCase, main solver) of the cylinder case with
    bigmesh_case.OPTIONS[name]."""
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.cases.casesolvers import SteadyFlowCase, build_space
    cfg = bigmesh_case.case_config(**bigmesh_case.OPTIONS[name])
    case = SteadyFlowCase(cfg)
    return case, case._make_solver(build_space(cfg), cfg.main)


def pc_times(solver, cm, u, cfl) -> dict:
    """A main step's Krylov operators at state u and `cfl`: the
    preconditioner's set-up (make_preconditioner: factorization, Galerkin
    operators, line factors) and one apply, and one matvec, in ms (CUDA
    events, median)."""
    import torch
    lmesh = cm.to(torch.float32) if solver.lin.mixed_precision else cm
    _, lrhs, ops = solver.step_operators(cm, u, cfl, lmesh)
    mv, pc = solver._linear_operators(ops)
    rec = dict(pc_setup_ms=event_ms(lambda: solver._linear_operators(ops), 5),
               pc_apply_ms=event_ms(lambda: pc(lrhs), 20),
               matvec_ms=event_ms(lambda: mv(lrhs), 10))
    if solver.lin.pc == "ilu0":
        from fvens_tpu_torch.solver.ilu import ilu_factorize
        rec["ilu_factor_ms"] = event_ms(lambda: ilu_factorize(
            ops.mesh, ops.jac, ops.ilu, sweeps=solver.lin.ilu_setup_sweeps),
            5)
    return rec


def gather_launch_checks(name: str, launches: dict, appends: int):
    check(launches["row_set"] == appends and appends > 0
          and launches["banded_apply"] == launches["banded_bsgs"] == 0,
          f"{name}: launches {launches} for {appends} basis appends")


def ilu_path(dev):
    """Phase F1: the cylinder case at OPTIONS_MESH with GATHER_ILU0, the
    starter and the main solve to 1e-10 or ILU_MAIN_STEPS steps: finite,
    falling residuals, row_set once per Krylov iteration (blocked GMRES);
    the ILU0 factorization and apply timed at the last state. Returns the
    launches."""
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.cases.casesolvers import build_space
    case, cm, u = bigmesh_case.build_case(dev, *OPTIONS_MESH,
                                          **bigmesh_case.GATHER_ILU0)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    u = case.execute_starter(cm, u)
    torch.cuda.synchronize()
    tm = time.perf_counter()
    solver = case._make_solver(build_space(case.cfg), case.cfg.main)
    u, info = solver.solve(cm, u, max_steps=ILU_MAIN_STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_counts()
    st = case.starter_info
    res = [h[2] for h in info.history]
    its = st.total_lin_iters + info.total_lin_iters
    card_line("F1 ilu0", dict(
        mesh=f"cylinder_omesh{OPTIONS_MESH}", cells=cm.n_cells,
        pc="ilu0", pc_sweeps=solver.lin.pc_sweeps,
        ilu_setup_sweeps=solver.lin.ilu_setup_sweeps,
        starter_steps=st.steps, starter_krylov_iters=st.total_lin_iters,
        starter_s=tm - t0, main_steps=info.steps, main_cap=ILU_MAIN_STEPS,
        main_krylov_iters=info.total_lin_iters,
        krylov_iters_per_step=info.total_lin_iters / max(info.steps, 1),
        converged=info.converged, final_res=res[-1],
        main_s_per_step=(t1 - tm) / max(info.steps, 1), wall_s=t1 - t0,
        residuals=res, launches=launches,
        **pc_times(solver, cm, u, info.history[-1][3])))
    check(bool(torch.isfinite(u).all()) and all(np.isfinite(r) for r in res),
          "the ilu0 run went non-finite")
    check(res[-1] < res[0], f"the ilu0 main residual did not fall: {res}")
    gather_launch_checks("F1 ilu0", launches, its)
    return launches


def options_steps(dev):
    """Phase F2: the bsgs x6 starter at OPTIONS_MESH, then OPTION_STEPS
    main steps from its state under each of F2_OPTIONS: finite residuals
    that fall, row_set once per Krylov iteration; seconds and Krylov
    iterations per step, the pc's set-up and apply; the AMG hierarchy and
    the lines. The amg run's first AMG_REPEAT_STEPS steps run twice and
    must repeat to the bit. Returns (mesh, starter state, launches by
    path)."""
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    case, cm, u = bigmesh_case.build_case(dev, *OPTIONS_MESH,
                                          **bigmesh_case.GATHER_BSGS)
    t0 = time.perf_counter()
    u = case.execute_starter(cm, u)
    torch.cuda.synchronize()
    st = case.starter_info
    print(f"F2 bsgs x6 starter at {OPTIONS_MESH}: {st.steps} steps, "
          f"{st.total_lin_iters} Krylov iterations, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out = {}
    for name in F2_OPTIONS:
        _, solver = option_solver(name)
        extra = {}
        if name == "amg":
            t0 = time.perf_counter()
            mg = solver._mg(cm)
            extra = dict(hierarchy_host_s=time.perf_counter() - t0,
                         levels=[dict(cells=int(lv.c_mask.sum()),
                                      padded=lv.NCp, slots=lv.S)
                                 for lv in mg.levels])
            first = [solver.solve(cm, u, max_steps=AMG_REPEAT_STEPS)[1]
                     .history for _ in range(2)]
            check(first[0] == first[1], "amg steps do not repeat: "
                  f"{first[0]} vs {first[1]}")
        if name == "bline":
            t0 = time.perf_counter()
            lines = solver._lines(cm)
            extra = dict(lines_host_s=time.perf_counter() - t0,
                         lines=lines.n_lines, Lmax=lines.Lmax)
        steps = JVP_STEPS if name == "mf-jvp" else OPTION_STEPS
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        un, info = solver.solve(cm, u, max_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        res = [h[2] for h in info.history]
        its = info.total_lin_iters
        card_line(f"F2 {name}", dict(
            mesh=f"cylinder_omesh{OPTIONS_MESH}", option=name,
            lin=bigmesh_case.OPTIONS[name], main_steps=info.steps,
            converged=info.converged, krylov_iters=its,
            krylov_iters_per_step=its / max(info.steps, 1),
            s_per_step=wall / max(info.steps, 1), wall_s=wall,
            residual_after=res[-1], residuals=res, launches=launches,
            **extra, **pc_times(solver, cm, un, info.history[-1][3])))
        check((info.steps == steps or info.converged)
              and all(np.isfinite(r) for r in res)
              and bool(torch.isfinite(un).all()),
              f"F2 {name}: {info.steps} steps, residuals {res}")
        check(res[-1] < res[0], f"F2 {name}: the residual did not fall")
        gather_launch_checks(f"F2 {name}", launches, its)
        out[f"F2 cylinder {OPTIONS_MESH[0]}x{OPTIONS_MESH[1]} {name}, "
            f"{steps} main steps"] = launches
    bline_lines_apply(dev)
    return cm, u, out


def bline_lines_apply(dev):
    """The line smoother where lines form: naca0012_omesh(BLINE_NACA_MESH)
    (the transonic ctrl's physics at free stream, f32 Jacobian at CFL
    1000): its lines, Lmax, and the set-up (the lines' elimination
    factors) and apply of 2 sweeps, in ms."""
    import torch
    from fvens_tpu_torch.io_config.ctrl import parse_control_file
    from fvens_tpu_torch.mesh import compile_mesh
    from fvens_tpu_torch.mesh.meshgen import naca0012_omesh
    from fvens_tpu_torch.cases.casesolvers import build_space, initial_state
    from fvens_tpu_torch.solver import jacobian as jacmod
    from fvens_tpu_torch.solver.lines import lines_from_mesh
    from fvens_tpu_torch.solver.linear import make_preconditioner
    cfg = parse_control_file(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), NACA_CTRL))
    cm = compile_mesh(naca0012_omesh(*BLINE_NACA_MESH), cfg.bcs,
                      dtype=torch.float64, device=dev)
    space = build_space(cfg)
    u = initial_state(space, cm)
    _, dt = space.compute_residual(cm, u, True)
    lm = cm.to(torch.float32)
    jac = jacmod.add_pseudotime_term(
        lm, space.assemble_jacobian(lm, u.float()), 1000.0, dt.float())
    t0 = time.perf_counter()
    lines = lines_from_mesh(cm)
    host_s = time.perf_counter() - t0
    v = torch.ones_like(u, dtype=torch.float32)
    pc = make_preconditioner(lm, jac, "bline", 2, lines=lines)
    z = pc(v)
    card_line("F2 bline on the NACA0012 O-mesh", dict(
        mesh=f"naca0012_omesh{BLINE_NACA_MESH}", cells=cm.n_cells,
        lines=lines.n_lines, Lmax=lines.Lmax, lines_host_s=host_s,
        pc_setup_ms=event_ms(lambda: make_preconditioner(
            lm, jac, "bline", 2, lines=lines), 5),
        pc_apply_ms=event_ms(lambda: pc(v), 20)))
    check(lines.Lmax > 1 and bool(torch.isfinite(z).all()),
          "no line formed on the NACA0012 O-mesh, or a non-finite apply")


def recycle_path(dev, cm, u, plain: dict):
    """Phase F3: from the F2 starter's state, the main solve with
    BSGS_RECYCLE (warm start, GCRO-DR k = 16 below the gate) to 1e-10 or
    RECYCLE_MAIN_STEPS steps, beside the plain bsgs x6 gather solve of
    this script (`plain`, gather_path's report): finite, falling
    residuals; row_set once per Krylov iteration of the steps before the
    gate opens (gmres_dr runs the classic path). Returns the launches."""
    import torch
    _, solver = option_solver("bsgs-recycle")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    un, info = solver.solve(cm, u, max_steps=RECYCLE_MAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    hist = info.history
    res = [h[2] for h in hist]
    gate = solver.lin.deflation_start_relres * hist[0][2]
    deflated = [k for k in range(1, len(hist)) if hist[k - 1][2] <= gate]
    blocked_its = sum(h[4] for k, h in enumerate(hist) if k not in deflated)
    card_line("F3 bsgs x6 + warm start + GCRO-DR", dict(
        mesh=f"cylinder_omesh{OPTIONS_MESH}", deflation_k=solver.lin.deflation_k,
        main_steps=info.steps, main_cap=RECYCLE_MAIN_STEPS,
        main_krylov_iters=info.total_lin_iters, converged=info.converged,
        final_res=res[-1], deflated_steps=len(deflated),
        s_per_step=wall / max(info.steps, 1), wall_s=wall, residuals=res,
        launches=launches,
        plain_bsgs=dict(main_steps=plain["main_steps"],
                        main_krylov_iters=plain["main_krylov_iters"],
                        converged=plain["converged"])))
    check(all(np.isfinite(r) for r in res) and bool(torch.isfinite(un).all()),
          "F3: non-finite residual")
    check(res[-1] < res[0], "F3: the residual did not fall")
    # retried steps (not in the history) would hide which solves recycled
    if len(info.step_times) == info.steps:
        gather_launch_checks("F3", launches, blocked_its)
    return launches


def options_vs_record(dev):
    """At OPTIONS_CHECK_MESH, each option of the JAX record's classic runs
    against that run: the starter's steps exactly (Krylov iterations within
    2%), the first OPTIONS_AGREE main steps step for step (Krylov
    iterations within 1, residuals within 1%); where OPTIONS_CHECK_STEPS
    runs to convergence, main steps and Krylov iterations within 10% of the
    range of the record's runs of the option (classic and blocked). Every
    option runs and prints where it first departs from the record before
    any failure is raised."""
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    rec = _load(JAX_OPTIONS_RECORD)
    mesh = f"cylinder_omesh{OPTIONS_CHECK_MESH}"
    bcase, cm, u0 = bigmesh_case.build_case(dev, *OPTIONS_CHECK_MESH,
                                            **bigmesh_case.GATHER_BSGS)
    u_bsgs = bcase.execute_starter(cm, u0)
    failures = []
    for run in (r for r in rec["runs"] if not r["blocked_gmres"]):
        name = run["option"]
        check(run["mesh"] == mesh, f"the record of {name} is not {mesh}")
        case, solver = option_solver(name)
        if run["starter"] == "own":
            u = case.execute_starter(cm, u0)
            st = case.starter_info
        else:
            u, st = u_bsgs, bcase.starter_info
        t0 = time.perf_counter()
        _, info = solver.solve(cm, u, max_steps=OPTIONS_CHECK_STEPS[name])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s, ref = run["starter_run"], run["main"]["history"]
        departs = next((k + 1 for k, (h, r) in enumerate(
            zip(info.history, ref)) if abs(h[4] - r[3]) > 1
            or abs(h[2] - r[1]) > 0.01 * r[1]), None)
        print(f"{mesh} {name}: starter {st.steps} / {st.total_lin_iters}, "
              f"main {info.steps} / {info.total_lin_iters} in {wall:.2f} s, "
              f"final {info.finalres!r}, first departs from the record at "
              f"main step {departs}; the JAX package's: starter "
              f"{s['steps']} / {s['krylov_iters']}, main "
              f"{run['main']['steps']} / {run['main']['krylov_iters']}, "
              f"final {run['main']['final_res']!r}; residuals "
              f"{[h[2] for h in info.history]}", flush=True)
        if not (st.steps == s["steps"] and abs(st.total_lin_iters
                                               - s["krylov_iters"])
                <= 0.02 * s["krylov_iters"]):
            failures.append(f"{name}: the starter departs from the JAX "
                            "package's")
        agree = OPTIONS_AGREE[name]
        if len(info.history) < agree or (departs is not None
                                         and departs <= agree):
            failures.append(f"{name}: main step {departs} departs from the "
                            f"record (held for {agree} steps)")
        if OPTIONS_CHECK_STEPS[name] is None:
            if not info.converged:
                failures.append(f"{name}: the {mesh} solve did not converge")
            refs = [r["main"] for r in rec["runs"] if r["option"] == name]
            for got, key in ((info.steps, "steps"),
                             (info.total_lin_iters, "krylov_iters")):
                vals = [r[key] for r in refs]
                if not 0.9 * min(vals) <= got <= 1.1 * max(vals):
                    failures.append(
                        f"{name}: main {key} {got} not within 10% of the "
                        f"JAX package's {min(vals)}-{max(vals)}")
    check(not failures, "; ".join(failures))


def options_phases(dev, paths: dict, gather_rep: dict):
    """Phase F: F1, F2 and F3 at OPTIONS_MESH (their launches into
    `paths`), then each option at OPTIONS_CHECK_MESH against the JAX
    record."""
    mesh = f"cylinder {OPTIONS_MESH[0]}x{OPTIONS_MESH[1]}"
    name = f"F1 {mesh} gather ilu0, starter + main to 1e-10 or " \
        f"{ILU_MAIN_STEPS} steps"
    with phase(name):
        paths[name] = ilu_path(dev)
    with phase(f"F2: {mesh} bsgs x6 starter, {OPTION_STEPS} main steps of "
               + ", ".join(F2_OPTIONS) + f" ({JVP_STEPS} of mf-jvp)"):
        cm, u, out = options_steps(dev)
        paths.update(out)
    name = f"F3 {mesh} bsgs x6 + warm start + GCRO-DR k=16, main to " \
        f"1e-10 or {RECYCLE_MAIN_STEPS} steps"
    with phase(name):
        paths[name] = recycle_path(dev, cm, u, gather_rep)
    del cm, u
    with phase(f"F: cylinder {OPTIONS_CHECK_MESH[0]}x"
               f"{OPTIONS_CHECK_MESH[1]} options vs the JAX record"):
        options_vs_record(dev)


# ---------------------------------------------------------------------------
# Phase G: the domain-decomposed path (fvens_tpu_torch/dist/). One card:
# NCCL refuses two ranks on one card, so G1 is one NCCL rank and G2/G3 run
# D ranks on cuda:0 over gloo, host-staged; G2's times are no scaling result.
# ---------------------------------------------------------------------------
DIST_MESH = (640, 320)           # G1, G2: cylinder_omesh, 204,800 cells
DIST_AGREE_STEPS = 10            # G1: main steps held to 1e-8 relative
DIST_PARTS = (2, 4)              # G2, G3: ranks sharing cuda:0 over gloo
DIST_STEPS = 3                   # G2: main steps from G1's starter state
DIST_CLI_MESH = CHECK_MESH       # G1's CLI pair (--devices 1, a resume)
# Phase J: the distributed step as one device program (J1 in G1's world,
# J2 in G2's D = 2 world)
# J1b: its residuals against J1's. Not bit for bit: the device form's
# f32 Krylov update is a product over the restart's 90 columns
# (linear.gmres_device), and a pipelined solve's first main step is the
# host form, so the two part at f32 rounding (the CPU rehearsal at 48x24,
# D = 2: up to 1.5e-6 over 10 steps). J1's first main residuals against
# G1's host loop, whose starter ran the host form too, are held to
# JAX_DIST_RECORD's agree_res, the limit of the other comparisons of two
# mixed-precision distributed trajectories (G3)
J_BAKED_STEPS = 10               # J1b: baked main steps from J1's starter
J_BAKED_REL = 1e-5
J_STAGED_STEPS = 3               # J2: device-form steps on the staged route
J_STAGED_REL = 1e-6              # J2: their residuals against _step's
# phase I1's pipelined one-device main step, ms (PERF.md section 5: an
# H100 80GB HBM3 at 700 W)
ONE_DEVICE_PIPELINED_MS = 51.3
DIST_CHECK_MESH = (160, 80)      # G3: held to JAX_DIST_RECORD's runs of
DIST_CHECK_PARTITION = "blocks"  # contiguous index blocks to convergence;
#   the record's "bfs" runs (partition_mesh's own) wander for 346-423 main
#   steps, about 115 s each on an H100, so G3 holds them over the record's
#   first agree_steps main steps only, and at these D:
DIST_BFS_PARTS = (2,)            # (D = 4's 20 steps took 40 s on an H100;
#   records/torch_dist_history.py holds every run to the record on the CPU)
JAX_DIST_RECORD = "records/jax_dist_history.json"
DIST_EXCHANGES = 50              # G2: exchanges timed per rank
DIST_ALLREDUCES = 200            # G1: NCCL reductions of a Hessenberg column
DIST_TIMEOUT = 300.0             # a world's process-group timeout, s
DIST_JOIN = 900.0                # and the longest it may run, s
WALL = (2,)                      # the cylinder's wall marker


def dist_case(mesh):
    """(the cylinder case's FlowCaseConfig with its wall marker, its
    MeshData at `mesh`)."""
    import dataclasses
    from fvens_tpu_torch.cases.bigmesh_case import case_config
    from fvens_tpu_torch.mesh.meshgen import cylinder_omesh
    return (dataclasses.replace(case_config(), wall_markers=WALL),
            cylinder_omesh(*mesh, stretch=1.15 ** (20.0 / mesh[1])))


def fnl_dict(f) -> dict:
    return {k: float(getattr(f, k)) for k in FUNCTIONALS}


def world(dev, D: int) -> dict:
    """launch.run's backend and device for D ranks on the card `dev`: one
    rank takes NCCL (one card per rank); more share the card over gloo
    (NCCL refuses two ranks on one card)."""
    return (dict(backend="nccl", device="cuda") if D == 1
            else dict(backend="gloo", device=str(dev)))


def allreduce_us(comm) -> float:
    """Microseconds per allreduce_sum of a GMRES(90) Hessenberg column (91
    f32 values), over DIST_ALLREDUCES reductions, synchronised."""
    import torch
    from fvens_tpu_torch.dist.comm import allreduce_sum
    h = torch.ones(91, dtype=torch.float32, device=comm.device)
    allreduce_sum(comm, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DIST_ALLREDUCES):
        allreduce_sum(comm, h)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / DIST_ALLREDUCES * 1e6


def g1_rank(comm, cfg, md):
    """G1's rank: DistributedFlowCase.rank_run_output, counted from just
    before to just after; returns its histories, launches, functionals,
    its wall split into set-up, starter, main solve and gather with the
    functionals, the cost of one reduction, and (rank 0) the gathered
    starter state."""
    import torch
    from fvens_tpu_torch.cases.casesolvers import DistributedFlowCase
    case = DistributedFlowCase(cfg, comm.size)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    _, info, fnls = case.rank_run_output(comm, md)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    st = case.starter_info
    split = dict(case.times, gather_functionals_s=wall - sum(
        case.times.values()))
    kernels = part_kernels(comm, cfg, case.flow, case.starter_u)
    out = dict(route=comm.route, wall_s=wall, split=split,
               allreduce_us=allreduce_us(comm), launches=launches,
               kernels=kernels,
               starter_steps=st.steps, starter_iters=st.total_lin_iters,
               history=info.history, main_steps=info.steps,
               main_iters=info.total_lin_iters, converged=info.converged,
               functionals=None if fnls is None else fnl_dict(fnls),
               starter=case.flow.gather_solution(case.starter_u))
    del case
    t0 = time.perf_counter()
    out["j1"] = j1_rank(comm, cfg, md)
    out["j1"]["j_s"] = time.perf_counter() - t0
    return out


def dist_one_rank(dev):
    """G1: the 640x320 banded cylinder through DistributedFlowCase on one
    NCCL rank, against the single-device banded solve with GMRES forced
    onto its classic path (a distributed solve's): the starter's steps
    equal, the first DIST_AGREE_STEPS main residuals to 1e-8 relative, the
    main steps within 10%, the functionals to 1e-8; K1 at least once and
    the fused K1b once per Krylov iteration (one part: no rest list), no
    row_set; then K1 and K1b against their twins on the part's operators
    at the starter's state. The rank runs in a process of its own, so this
    process solves the one-device case and computes G2's one-device forms
    (g2_reference) while it runs; their walls overlap the world's. The
    one-device run's set-up (mesh and case) and the world's start are
    timed beside G1's split of its wall. Returns (the starter's state, the
    run's launches, g2_reference's forms)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.cases.casesolvers import build_space
    from fvens_tpu_torch.dist import launch
    from fvens_tpu_torch.output import entropy_error, surface_data
    from fvens_tpu_torch.solver import linear
    cfg, md = dist_case(DIST_MESH)
    with ThreadPoolExecutor(1) as ex:
        t_world = time.perf_counter()
        job = ex.submit(launch.run, g1_rank, 1, args=(cfg, md),
                        timeout=DIST_TIMEOUT, join_timeout=DIST_JOIN,
                        **world(dev, 1))
        keep = linear._BLOCKED_N_THRESHOLD
        linear._BLOCKED_N_THRESHOLD = 1 << 62
        try:
            t0 = time.perf_counter()
            case, cm, u0 = bigmesh_case.build_case(dev, *DIST_MESH)
            ref_build = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u, info = case.solve(cm, u0)
            torch.cuda.synchronize()
            ref_wall = time.perf_counter() - t0
        finally:
            linear._BLOCKED_N_THRESHOLD = keep
        space = build_space(cfg)
        ref_f = dict(zip(FUNCTIONALS, [entropy_error(space, cm, u)]
                         + [float(x) for x in surface_data(space, cm, u,
                                                           WALL)[1]]))
        ref_st = case.starter_info
        del case, cm, u, u0
        t0 = time.perf_counter()
        parity_ref = g2_reference(dev, cfg, md)
        parity_ref_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        got = job.result()[0]
    got["world_s"] = time.perf_counter() - t_world
    starter = got.pop("starter")
    hist, ref_h = got.pop("history"), info.history
    its = got["starter_iters"] + got["main_iters"]
    launches = got["launches"]
    card_line(f"G1 cylinder {DIST_MESH[0]}x{DIST_MESH[1]} banded, D=1, "
              f"{got['route']}", dict(
        got, mesh=f"cylinder_omesh{DIST_MESH}", cells=md.nelem,
        krylov_iters=its, residuals=[h[2] for h in hist],
        single_device=dict(starter_steps=ref_st.steps,
                           starter_iters=ref_st.total_lin_iters,
                           main_steps=info.steps,
                           main_iters=info.total_lin_iters, wall_s=ref_wall,
                           build_s=ref_build, functionals=ref_f,
                           gmres="classic (forced)",
                           beside="the G1 world"),
        g2_reference_s=parity_ref_s,
        agree_rel=[abs(a[2] - b[2]) / b[2] for a, b in
                   zip(hist[:DIST_AGREE_STEPS], ref_h)]))
    check(got["converged"] and info.converged, "G1: a solve did not converge")
    check(got["starter_steps"] == ref_st.steps,
          f"G1: starter {got['starter_steps']} steps, single device "
          f"{ref_st.steps}")
    for a, b in zip(hist[:DIST_AGREE_STEPS], ref_h):
        check(abs(a[2] - b[2]) <= 1e-8 * b[2],
              f"G1 main step {a[0]}: residual {a[2]!r} vs {b[2]!r}")
    check(abs(got["main_steps"] - info.steps) <= 0.1 * info.steps,
          f"G1: {got['main_steps']} main steps vs {info.steps}")
    check(same_functionals(got["functionals"], ref_f, 1e-8),
          f"G1 functionals {got['functionals']} vs {ref_f}")
    check(launches["banded_apply"] >= its and launches["banded_bsgs"] >= its
          and launches["row_set"] == 0,
          f"G1: launches {launches} for {its} Krylov iterations")
    kern = got["kernels"]
    check(kern["fused"] and kern["matvec"]["ok"] and kern["bsgs"]["ok"],
          f"G1: K1 or the fused K1b on the part's operators differs from "
          f"its twin: {kern}")
    j1 = j1_checks(got.pop("j1"), got, hist)
    return starter, launches, parity_ref, j1


def dist_cli(ref: dict):
    """G1's CLI: `python -m fvens_tpu_torch.cases.cli --devices 1` (one
    NCCL rank) on the committed cylinder ctrl at DIST_CLI_MESH (160x80:
    the one-device CLI at 640x320 is step 12's and the distributed solve
    at 640x320 G1's; what the pair alone shows, that the CLI reaches
    DistributedFlowCase and resumes from its stacked checkpoint, holds at
    any size) with a VTU, the surface table, the history and a
    checkpoint, then again, resuming (at main step 50 of 51); its
    functionals within 1e-8 of the one-device CLI's at the same mesh
    (`ref`, cli_vs_record's run), the rerun's of the first's. CL, zero by
    symmetry, is held absolutely, to JAX_DIST_RECORD's cl_abs. Logs in
    CLI_LOG_DIR. Runs beside G2 and G3 (dist_phases)."""
    import tempfile
    import xml.etree.ElementTree as ET
    cl_abs = _load(JAX_DIST_RECORD)["limits"]["cl_abs"]
    ni, nj = DIST_CLI_MESH
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        p = {k: os.path.join(tmp, f) for k, f in (
            ("msh", "cylinder.msh"), ("vtu", "cylinder.vtu"),
            ("surface", "surface.dat"), ("history", "history.jsonl"),
            ("history2", "history2.jsonl"), ("checkpoint", "ck.npz"))}
        write_cylinder_msh(p["msh"], ni, nj)
        base = [sys.executable, "-m", "fvens_tpu_torch.cases.cli", CLI_CTRL,
                "--mesh_file", p["msh"], "-options_file", CLI_SOLVERC,
                "--device", "cuda", "--devices", "1", "--checkpoint",
                p["checkpoint"], "--log_every", "1"]
        for i, extra in enumerate((
                ["--vtu", p["vtu"], "--surface", p["surface"], "--history",
                 p["history"]], ["--history", p["history2"]])):
            t0 = time.perf_counter()
            proc = subprocess.run(base + extra, capture_output=True,
                                  text=True, timeout=900)
            wall = time.perf_counter() - t0
            os.makedirs(CLI_LOG_DIR, exist_ok=True)
            with open(os.path.join(CLI_LOG_DIR, f"cli_devices1_{ni}x{nj}"
                                   f"{'_resume' if i else ''}.log"), "w") as f:
                f.write(proc.stdout + proc.stderr)
            check(proc.returncode == 0, f"G1 CLI --devices 1 exited "
                  f"{proc.returncode}: {proc.stderr[-2000:]}")
            runs.append(dict(wall_s=wall, **parse_cli_output(proc.stdout),
                             ranks_line="1 ranks (nccl)" in proc.stdout))
        rows = read_jsonl(p["history"])
        rows2 = read_jsonl(p["history2"])
        piece = ET.parse(p["vtu"]).getroot().find("UnstructuredGrid/Piece")
        cells = int(piece.get("NumberOfCells"))
        surf = np.loadtxt(p["surface"])
    run, run2 = runs
    rep = dict(mesh=f"cylinder_omesh{DIST_CLI_MESH}", route="nccl",
               wall_s=run["wall_s"], main_steps=run["main_steps"],
               main_iters=run["main_iters"],
               functionals={k: run[k] for k in FUNCTIONALS},
               resumed_at=min(r["step"] for r in rows2) - 1 if rows2
               else None, resumed_wall_s=run2["wall_s"],
               one_device_functionals=ref)
    card_line(f"G1 cli --devices 1 {ni}x{nj}, nccl", rep)
    check(run["ranks_line"] and not run["resumed"],
          "G1 CLI: not one NCCL rank, or resumed on its first run")
    check(len(rows) == run["main_steps"] and cells == ni * nj
          and surf.shape == (ni, 4),
          f"G1 CLI outputs: {len(rows)} history lines, {cells} VTU cells, "
          f"surface {surf.shape}")
    check(same_functionals(run, ref, 1e-8, cl_abs),
          f"G1 CLI functionals {rep['functionals']} vs the one-device "
          f"CLI's {ref}")
    check(run2["resumed"] and same_functionals(run2, run, 1e-8),
          "G1 CLI: the rerun did not resume to the same functionals")


def g2_exchange_us(flow) -> float:
    """Microseconds per halo exchange of an f32 (NC, 4) field (a Krylov
    vector), over DIST_EXCHANGES exchanges, synchronised."""
    import torch
    from fvens_tpu_torch.dist.comm import halo_exchange
    x = torch.ones((flow.mesh.NC, 4), dtype=torch.float32,
                   device=flow.comm.device)
    halo_exchange(flow.exch, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DIST_EXCHANGES):
        halo_exchange(flow.exch, x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / DIST_EXCHANGES * 1e6


def g2_seeded(space, mesh):
    """G2's seeded state on `mesh`: the free stream perturbed smoothly."""
    import torch
    uinf = space.uinf(torch.float64, mesh.rc.device)
    rc = mesh.rc
    pert = 0.05 * torch.sin(rc[:, 0]) * torch.cos(rc[:, 1])
    w = torch.tensor([1.0, 0.5, -0.5, 1.0], dtype=torch.float64,
                     device=rc.device)
    return uinf * (1.0 + pert[:, None] * w)


def g2_step_configs():
    """(lin, nl) of G2's bjacobi step: rtol 1e-10, one cycle of 80."""
    from fvens_tpu_torch.config import (LinearSolverConfig,
                                        NonlinearUpdateConfig)
    return (LinearSolverConfig(restart=80, maxiter=80, rtol=1e-10,
                               rtol_adapt=False, pc="bjacobi"),
            NonlinearUpdateConfig(scheme="full"))


def g2_reference(dev, cfg, md) -> dict:
    """The one-device forms G2's parity holds the parts to, computed once
    for every D: the residual and time steps at g2_seeded's state, and one
    bjacobi step from the free stream with classic GMRES (a distributed
    solve's path), as numpy arrays over the real cells."""
    import torch
    from fvens_tpu_torch.cases.casesolvers import build_space
    from fvens_tpu_torch.config import PseudoTimeConfig
    from fvens_tpu_torch.mesh.device_mesh import compile_mesh
    from fvens_tpu_torch.solver import linear
    from fvens_tpu_torch.solver.steady import SteadyBackwardEuler
    space = build_space(cfg)
    cm = compile_mesh(md, cfg.bcs, dtype=torch.float64, device=dev)
    n = cm.n_cells
    s_rhs, s_dt = space.compute_residual(cm, g2_seeded(space, cm), True)
    be = SteadyBackwardEuler(space, PseudoTimeConfig(), *g2_step_configs())
    keep = linear._BLOCKED_N_THRESHOLD
    linear._BLOCKED_N_THRESHOLD = 1 << 62       # the classic path
    try:
        s_u1, s_res1, s_it1 = be._step(
            cm, space.uinf(torch.float64, dev).repeat(cm.NC, 1), 50.0, 1e-10)
    finally:
        linear._BLOCKED_N_THRESHOLD = keep
    s_rhs, s_dt, s_u1 = (t[:n].cpu().numpy() for t in (s_rhs, s_dt, s_u1))
    return dict(rhs=s_rhs, dt=s_dt, u1=s_u1, res1=s_res1, it1=s_it1)


def g2_parity(comm, flow, ref) -> dict:
    """G2's parity checks at 640x320: the sharded residual at g2_seeded's
    state against the one-device residual (rtol 1e-10, atol 1e-12; dt
    atol 1e-14), and one bjacobi step at rtol 1e-10 against the one-device
    step with classic GMRES (res 1e-10; u 1e-7, 1e-9), compared on rank 0
    with `ref`, g2_reference's one-device forms."""
    from fvens_tpu_torch.config import PseudoTimeConfig
    from fvens_tpu_torch.dist.shard import DistributedBackwardEuler
    space = flow.space
    rhs, dt = flow.residual(g2_seeded(space, flow.mesh))
    g_rhs = flow.gather_solution(rhs)
    g_dt = flow.gather_solution(dt[:, None])
    lin, nl = g2_step_configs()
    dbe = DistributedBackwardEuler(space=space, cfg=PseudoTimeConfig(),
                                   lin=lin, nl=nl, flow=flow)
    u1, res1, it1 = dbe._step(flow.dist_mesh(), flow.initial_state(), 50.0,
                              1e-10)
    g_u1 = flow.gather_solution(u1)
    if comm.rank != 0:
        return {}
    s_rhs, s_dt, s_u1 = ref["rhs"], ref["dt"], ref["u1"]
    s_res1, s_it1 = ref["res1"], ref["it1"]
    return dict(
        residual_ok=bool(np.allclose(g_rhs, s_rhs, rtol=1e-10, atol=1e-12)
                         and np.allclose(g_dt[:, 0], s_dt, rtol=1e-10,
                                         atol=1e-14)),
        residual_max_err=float(np.abs(g_rhs - s_rhs).max()),
        step_ok=bool(abs(res1 - s_res1) <= 1e-10 * s_res1
                     and np.allclose(g_u1, s_u1, rtol=1e-7, atol=1e-9)),
        step_res=[res1, s_res1], step_iters=[it1, s_it1],
        step_max_err=float(np.abs(g_u1 - s_u1).max()))


def part_kernels(comm, cfg, flow, u) -> dict:
    """The banded operators this part's solve launches (the solver's
    _linear_operators: K1, plus the rest list where the part has one; for
    bsgs the fused K1b where it has none, else K1's seven-launch sequence
    plus the rest) against their plain twins on the part's step-0
    operators (mixed precision: f32) at its state u: max abs error <=
    1e-5 max|y|; and the time of each (CUDA events). These launches come
    after the counted run."""
    import torch
    from functools import partial
    from fvens_tpu_torch.dist.comm import allreduce_sum, halo_exchange
    from fvens_tpu_torch.dist.shard import DistributedBackwardEuler
    from fvens_tpu_torch.solver import banded
    from fvens_tpu_torch.solver import banded_kernels as bk
    be = DistributedBackwardEuler(space=flow.space, cfg=cfg.main,
                                  lin=cfg.linear, nl=cfg.nl_update, flow=flow)
    dm = flow.dist_mesh()
    bl = be._banded(dm)
    ex = partial(halo_exchange, flow.exch)
    _, _, ops = be.step_operators(
        dm.mesh, ex(u), cfg.main.cfl_init, dm.mesh.to(torch.float32), bl,
        exchange=ex, allreduce=partial(allreduce_sum, comm))
    mv, pc = be._linear_operators(ops)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (flow.mesh.NC, 4)).astype(np.float32)).to(comm.device)
    pairs = dict(
        matvec=(mv, banded.make_banded_matvec(ops.D, ops.Bt, bl.offsets, bl,
                                              ops.R)),
        bsgs=(pc, banded.make_banded_bsgs(ops.Dinv, ops.DNbt, bl.offsets,
                                          cfg.linear.pc_sweeps, bl,
                                          ops.DNr)))
    out = dict(rest_blocks=int(bl.rest_cell.numel()) if bl.has_rest else 0,
               bands=len(bl.offsets), fused=not bl.has_rest)
    k0 = bk.banded_apply.launches
    mv(x)
    out["matvec_launches"] = bk.banded_apply.launches - k0
    for name, (kern, plain) in pairs.items():
        y, want = kern(x), plain(x)
        err = float((y - want).abs().max())
        out[name] = dict(max_abs_err=err, ok=err <= 1e-5 * float(
            want.abs().max()), ms=event_ms(lambda: kern(x)),
            plain_ms=event_ms(lambda: plain(x)))
    return out


def g23_rank(comm, cfg, md, starter, md_check, part_check, bfs_steps,
             parity_ref):
    """G2 and G3 on one rank of a gloo world on cuda:0: the parity checks
    (against `parity_ref`, g2_reference's one-device forms),
    the kernel checks, DIST_STEPS main steps of the banded bsgs x6 solve
    from G1's starter state scattered to the parts (counted), then the
    DIST_CHECK_MESH solve through DistributedFlowCase on the given parts
    to convergence, and (`bfs_steps` not None) on partition_mesh's own
    (BFS) parts for the starter and `bfs_steps` main steps."""
    import dataclasses
    import torch
    from fvens_tpu_torch.cases.casesolvers import (DistributedFlowCase,
                                                   build_space)
    from fvens_tpu_torch.dist.partition import partition_mesh
    from fvens_tpu_torch.dist.shard import (DistributedBackwardEuler,
                                            ShardedFlow)
    from fvens_tpu_torch.solver.steady import ToleranceError
    t0 = time.perf_counter()
    flow = ShardedFlow(build_space(cfg), partition_mesh(md, cfg.bcs,
                                                        comm.size), comm)
    out = dict(rank=comm.rank, route=comm.route,
               partition_s=time.perf_counter() - t0,
               own_cells=flow.mesh.n_cells, NC_local=flow.mesh.NC,
               halo_cells=flow.exch.halo_cells, rounds=len(flow.exch.rounds),
               bytes_per_exchange_f32=flow.exch.halo_cells * 16)
    out["parity"] = g2_parity(comm, flow, parity_ref)
    u = flow.scatter(starter)
    out["kernels"] = part_kernels(comm, cfg, flow, u)
    out["us_per_exchange"] = g2_exchange_us(flow)
    be = DistributedBackwardEuler(space=flow.space, cfg=cfg.main,
                                  lin=cfg.linear, nl=cfg.nl_update, flow=flow)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    un, info = be.solve(flow.dist_mesh(), u, max_steps=DIST_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out.update(launches=read_counts(), steps=info.steps,
               krylov_iters=info.total_lin_iters, wall_s=wall,
               s_per_step=wall / max(info.steps, 1),
               residuals=[h[2] for h in info.history],
               finite=bool(torch.isfinite(un).all()))
    if comm.size == 2:
        t0 = time.perf_counter()
        out["j2"] = j2_rank(comm, cfg, flow, u)
        out["j2"]["j_s"] = time.perf_counter() - t0
    del flow, be, u, un
    case = DistributedFlowCase(cfg, comm.size)
    t0 = time.perf_counter()
    _, info, fnls = case.rank_run_output(comm, md_check, part=part_check)
    st = case.starter_info
    out["check"] = dict(
        wall_s=time.perf_counter() - t0, starter_steps=st.steps,
        starter_iters=st.total_lin_iters, main_steps=info.steps,
        main_iters=info.total_lin_iters, converged=info.converged,
        history=info.history,
        functionals=None if fnls is None else fnl_dict(fnls))
    if bfs_steps is None:
        return out
    capped = dataclasses.replace(cfg, main=dataclasses.replace(
        cfg.main, maxiter=bfs_steps))
    case = DistributedFlowCase(capped, comm.size)
    t0 = time.perf_counter()
    try:
        _, info, _ = case.rank_run_output(comm, md_check)
    except ToleranceError as e:         # stopped at bfs_steps, as asked
        info = e.info
    st = case.starter_info
    out["check_bfs"] = dict(
        wall_s=time.perf_counter() - t0, starter_steps=st.steps,
        main_steps=info.steps, main_iters=info.total_lin_iters,
        history=info.history)
    return out


def dist_shared_card(dev, starter, parity_ref) -> dict:
    """G2 and G3 for each D of DIST_PARTS: D ranks on cuda:0 over gloo,
    host-staged, each world once, the worlds of every D at the same time
    (so their per-rank times are taken beside each other). G2
    (DIST_MESH): the sharded residual and
    one bjacobi step equal the one-device ones, K1 + rest and the bsgs
    sequence + rest equal their twins, and DIST_STEPS main steps from
    G1's starter state stay finite and fall, with K1 at least once and
    once more per sweep (7 per pc apply) per Krylov iteration, no fused
    K1b (every part has a rest list) and no row_set; per rank: s/step,
    Krylov iterations, halo cells, rounds, bytes and us per exchange, K1
    launches. G3 (DIST_CHECK_MESH): the solve on contiguous blocks against
    JAX_DIST_RECORD's run of D parts within the limits the record states
    (the totals from above and from below), and for D in DIST_BFS_PARTS on
    the BFS parts its starter and first agree_steps main steps against the
    record's BFS run.
    Returns the G2 launches by path (summed over the ranks)."""
    from concurrent.futures import ThreadPoolExecutor

    from fvens_tpu_torch.dist import launch
    rec = _load(JAX_DIST_RECORD)
    lim = rec["limits"]
    near = lim["near_tol"] * rec["case"]["config"]["main"]["tol_abs"]
    cfg, md = dist_case(DIST_MESH)
    _, md_check = dist_case(DIST_CHECK_MESH)
    paths = {}

    def run_world(D):
        """(the ranks' results, the world's seconds) of D ranks."""
        n = md_check.nelem
        part = np.minimum(np.arange(n) * D // n, D - 1)   # the record's
        bfs_steps = lim["agree_steps"] if D in DIST_BFS_PARTS else None
        t0 = time.perf_counter()
        ranks = launch.run(g23_rank, D, args=(cfg, md, starter, md_check,
                                              part, bfs_steps, parity_ref),
                           timeout=DIST_TIMEOUT, join_timeout=DIST_JOIN,
                           **world(dev, D))
        return ranks, time.perf_counter() - t0

    # the worlds run at once, each in its own processes
    with ThreadPoolExecutor(len(DIST_PARTS)) as ex:
        jobs = {D: ex.submit(run_world, D) for D in DIST_PARTS}
        worlds = {D: job.result() for D, job in jobs.items()}
    paths["j2"] = j2_checks(worlds[2][0])
    for D in DIST_PARTS:
        ranks, world_s = worlds[D]
        bfs_steps = lim["agree_steps"] if D in DIST_BFS_PARTS else None
        route = ranks[0]["route"]
        check(all(r["route"] == "gloo, host-staged" for r in ranks),
              f"G2 D={D}: routes {[r['route'] for r in ranks]}")
        par = ranks[0]["parity"]
        g3 = ranks[0]["check"]
        for r in ranks:
            card_line(f"G2 cylinder {DIST_MESH[0]}x{DIST_MESH[1]}, D={D} on "
                      f"one card, {route}, rank {r['rank']}",
                      {k: v for k, v in r.items()
                       if k not in ("parity", "check")})
        card_line(f"G2 D={D} parity ({route})", dict(par, world_s=world_s))
        check(par["residual_ok"], f"G2 D={D}: the sharded residual differs "
              f"by {par['residual_max_err']!r}")
        check(par["step_ok"] and par["step_iters"][0] == par["step_iters"][1],
              f"G2 D={D}: the bjacobi step differs: {par}")
        for r in ranks:
            for name in ("matvec", "bsgs"):
                check(r["kernels"][name]["ok"],
                      f"G2 D={D} rank {r['rank']}: K1 {name} with the rest "
                      f"list differs from its twin: {r['kernels'][name]}")
            res = r["residuals"]
            check(r["finite"] and r["steps"] == DIST_STEPS
                  and all(np.isfinite(res)) and res[-1] < res[0],
                  f"G2 D={D} rank {r['rank']}: steps {r['steps']}, "
                  f"residuals {res}")
            # the matvec, and the 7-launch bsgs sequence where the part
            # has a rest list (else the fused K1b)
            la, its = r["launches"], r["krylov_iters"]
            rest = r["kernels"]["rest_blocks"] > 0
            per_it = r["kernels"]["matvec_launches"] + (7 if rest else 0)
            check(la["banded_apply"] >= its * per_it
                  and la["banded_bsgs"] == (0 if rest else
                                            la["banded_bsgs"])
                  and (rest or la["banded_bsgs"] >= its)
                  and la["row_set"] == 0,
                  f"G2 D={D} rank {r['rank']}: launches {la} for {its} "
                  f"Krylov iterations, rest list {rest}")
        paths[f"G2 cylinder {DIST_MESH[0]}x{DIST_MESH[1]} banded, D={D} on "
              f"one card, {route}, {DIST_STEPS} main steps"] = {
            k: sum(r["launches"][k] for r in ranks) for k in KERNELS}
        want = next(r for r in rec["runs"] if r["parts"] == D
                    and r["partition"] == DIST_CHECK_PARTITION)
        wm = want["main"]
        card_line(f"G3 cylinder {DIST_CHECK_MESH[0]}x{DIST_CHECK_MESH[1]}, "
                  f"D={D} ({DIST_CHECK_PARTITION}) on one card, {route}",
                  dict(
                      {k: v for k, v in g3.items() if k != "history"},
                      jax=dict(starter_steps=want["starter"]["steps"],
                               main_steps=wm["steps"],
                               main_iters=wm["krylov_iters"],
                               functionals=want["functionals"])))
        check(g3["converged"] and g3["starter_steps"]
              == want["starter"]["steps"],
              f"G3 D={D}: starter {g3['starter_steps']} steps vs "
              f"{want['starter']['steps']}, converged {g3['converged']}")
        for h, (step, res, _, its) in zip(g3["history"][:lim["agree_steps"]],
                                          wm["history"]):
            check(abs(h[4] - its) <= lim["agree_iters"]
                  and abs(h[2] - res) <= lim["agree_res"] * res,
                  f"G3 D={D} main step {step}: iterations {h[4]} vs {its}, "
                  f"residual {h[2]!r} vs {res!r}")
        # from below: the steps and Krylov iterations the record took to
        # come within near_tol times the tolerance
        floor = next((h[0], sum(x[3] for x in wm["history"][:h[0]]))
                     for h in wm["history"] if h[1] <= near)
        check((1 - lim["main_steps"]) * floor[0] <= g3["main_steps"]
              <= (1 + lim["main_steps"]) * wm["steps"]
              and (1 - lim["krylov_iters"]) * floor[1] <= g3["main_iters"]
              <= (1 + lim["krylov_iters"]) * wm["krylov_iters"],
              f"G3 D={D}: {g3['main_steps']} / {g3['main_iters']} against "
              f"the record's {wm['steps']} / {wm['krylov_iters']} (within "
              f"{near:g} at {floor[0]} / {floor[1]})")
        got_f, want_f = g3["functionals"], want["functionals"]
        check(all(abs(got_f[k] - want_f[k]) <= (
            lim["cl_abs"] if k == "CL" else lim["functionals"]
            * abs(want_f[k])) for k in FUNCTIONALS),
              f"G3 D={D}: functionals {got_f} vs {want_f}")
        if bfs_steps is None:
            continue
        bfs = ranks[0]["check_bfs"]
        wb = next(r for r in rec["runs"] if r["parts"] == D
                  and r["partition"] == "bfs")
        card_line(f"G3 cylinder {DIST_CHECK_MESH[0]}x{DIST_CHECK_MESH[1]}, "
                  f"D={D} (bfs, {lim['agree_steps']} main steps) on one "
                  f"card, {route}", dict(
                      {k: v for k, v in bfs.items() if k != "history"},
                      residuals=[h[2] for h in bfs["history"]],
                      jax=dict(starter_steps=wb["starter"]["steps"],
                               residuals=[h[1] for h in wb["main"]["history"]
                                          [:lim["agree_steps"]]])))
        check(bfs["starter_steps"] == wb["starter"]["steps"]
              and bfs["main_steps"] == lim["agree_steps"],
              f"G3 D={D} bfs: starter {bfs['starter_steps']} steps vs "
              f"{wb['starter']['steps']}, {bfs['main_steps']} main steps")
        for h, (step, res, _, its) in zip(bfs["history"],
                                          wb["main"]["history"]):
            check(abs(h[4] - its) <= lim["agree_iters"]
                  and abs(h[2] - res) <= lim["agree_res"] * res,
                  f"G3 D={D} bfs main step {step}: iterations {h[4]} vs "
                  f"{its}, residual {h[2]!r} vs {res!r}")
    return paths


# ---------------------------------------------------------------------------
# Phase J: the distributed step as one device program (dist/shard.py:
# DistributedBackwardEuler._device_step, pipelined, baked, and on the
# host-staged route)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counted_solves(dev, marks: list):
    """Inside: each ShardedFlow.solve_implicit appends to `marks` the
    launches counted on the card across it (solver/device_counts must be
    on) and its SolveInfo."""
    import torch
    from fvens_tpu_torch.dist.shard import ShardedFlow
    from fvens_tpu_torch.solver.steady import ToleranceError
    saved = ShardedFlow.solve_implicit

    def run(self, *a, **k):
        torch.cuda.synchronize()
        n0 = device_launches(dev)

        def mark(info):
            torch.cuda.synchronize()
            n1 = device_launches(dev)
            marks.append(({key: n1[key] - n0[key] for key in n1}, info))
        try:
            out = saved(self, *a, **k)
        except ToleranceError as e:
            mark(e.info)
            raise
        mark(out[1])
        return out
    ShardedFlow.solve_implicit = run
    try:
        yield
    finally:
        ShardedFlow.solve_implicit = saved


# CUgraphNodeType (cuda.h) by value
GRAPH_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
                    "wait_event", "event_record", "ext_semas_signal",
                    "ext_semas_wait", "mem_alloc", "mem_free",
                    "batch_mem_op", "conditional")


def graph_nodes(graph: int, bodies: list) -> dict:
    """The nodes of a captured CUDA graph (a cudaGraph_t handle) and of the
    body graphs of its IF nodes (`bodies`, as captured: this libcuda has no
    getter for a conditional node's bodies), read through libcuda's calls:
    counts by node type at the top level and inside the bodies, and the
    kernel nodes whose function name is NCCL's at each."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def ok(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUresult {err}")

    def name_of(node):
        prm = (ctypes.c_byte * 72)()          # CUDA_KERNEL_NODE_PARAMS_v2
        ok(cu.cuGraphKernelNodeGetParams_v2(vp(node), prm),
           "cuGraphKernelNodeGetParams_v2")
        func = ctypes.c_void_p.from_buffer(prm, 0).value
        kern = ctypes.c_void_p.from_buffer(prm, 56).value
        name = ctypes.c_char_p()
        if func:
            ok(cu.cuFuncGetName(ctypes.byref(name), vp(func)), "cuFuncGetName")
        elif kern:
            ok(cu.cuKernelGetName(ctypes.byref(name), vp(kern)),
               "cuKernelGetName")
        return (name.value or b"").decode()

    out = {"top": {}, "in_if_bodies": {}, "nccl_kernels": {},
           "if_bodies": len(bodies)}

    def walk(g, level):
        n = ctypes.c_size_t(0)
        ok(cu.cuGraphGetNodes(vp(g), None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (vp * n.value)()
        ok(cu.cuGraphGetNodes(vp(g), nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
        for node in nodes:
            t = ctypes.c_int()
            ok(cu.cuGraphNodeGetType(vp(node), ctypes.byref(t)),
               "cuGraphNodeGetType")
            kind = (GRAPH_NODE_TYPES[t.value] if t.value
                    < len(GRAPH_NODE_TYPES) else str(t.value))
            out[level][kind] = out[level].get(kind, 0) + 1
            if kind == "kernel" and "nccl" in name_of(node).lower():
                out["nccl_kernels"][level] = \
                    out["nccl_kernels"].get(level, 0) + 1
            elif kind == "graph":
                child = vp()
                ok(cu.cuGraphChildGraphNodeGetGraph(vp(node),
                                                    ctypes.byref(child)),
                   "cuGraphChildGraphNodeGetGraph")
                walk(child.value, level)
    walk(graph, "top")
    for body in bodies:
        walk(body, "in_if_bodies")
    return out


def captured_nodes(dev, program) -> dict:
    """The body of `program` (a StepProgram that has run: its workspace
    and caches exist) captured once more into a CUDA graph that keeps its
    cudaGraph_t, as the program captures it (IF nodes, or masked), each IF
    node's body graph noted as its capture begins (cuStreamGetCaptureInfo
    on the body stream); their nodes read by graph_nodes."""
    import ctypes
    import torch
    from fvens_tpu_torch.solver.graph_if import GraphControl
    from fvens_tpu_torch.solver.linear import EAGER
    cu = ctypes.CDLL("libcuda.so.1")
    bodies = []

    class Noting(GraphControl):
        def _body(self, begin, body):
            def noted(arg):
                status, graph = ctypes.c_int(), ctypes.c_void_p()
                err = cu.cuStreamGetCaptureInfo_v2(
                    ctypes.c_void_p(torch.cuda.current_stream(
                        self.device).cuda_stream), ctypes.byref(status),
                    None, ctypes.byref(graph), None, None)
                if err != 0:
                    raise RuntimeError(f"cuStreamGetCaptureInfo_v2: CUresult "
                                       f"{err}")
                bodies.append(graph.value)
                body(arg)
            super()._body(begin, noted)

    ctl = EAGER if program.program.masked else Noting(dev)
    pool = torch.cuda.MemPool()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            with torch.cuda.use_mem_pool(pool, dev):
                program._body(ctl)
        return graph_nodes(graph.raw_cuda_graph(), bodies)
    except (RuntimeError, OSError, AttributeError, TypeError) as e:
        return {"error": str(e)[:300]}


def j1_rank(comm, cfg, md) -> dict:
    """J1 and J1b on G1's rank. J1: DistributedFlowCase with pipeline set
    on the starter and the main solve, the launches counted on the card
    across each solve; J1b: bake_mesh for J_BAKED_STEPS main steps from
    J1's starter state, then its step's graph read (captured_nodes) and an
    allreduce run under no_host_sync."""
    import dataclasses
    import torch
    from fvens_tpu_torch.cases.casesolvers import DistributedFlowCase
    from fvens_tpu_torch.dist.comm import allreduce_sum
    from fvens_tpu_torch.dist.shard import DistributedBackwardEuler
    from fvens_tpu_torch.solver import device_counts
    from fvens_tpu_torch.solver.device_stepping import no_host_sync
    dev = comm.device
    pipe = dataclasses.replace(
        cfg, main=dataclasses.replace(cfg.main, pipeline=True),
        init=dataclasses.replace(cfg.init, pipeline=True))
    case = DistributedFlowCase(pipe, comm.size)
    marks = []
    torch.cuda.synchronize()
    device_counts.enable(dev)
    try:
        t0 = time.perf_counter()
        with counted_solves(dev, marks):
            _, info, fnls = case.rank_run_output(comm, md)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = device_launches(dev)
    finally:
        device_counts.disable()
    st = case.starter_info
    (n_st, _), (n_main, _) = marks
    out = dict(route=comm.route, wall_s=wall, split=dict(case.times),
               launches=launches,
               per_step=dict(starter=per_step(n_st, st),
                             main=per_step(n_main, info)),
               starter_steps=st.steps, starter_iters=st.total_lin_iters,
               starter_capture_s=st.capture_s, main_capture_s=info.capture_s,
               device_iters=st.device_lin_iters + info.device_lin_iters,
               discarded_iters=(st.discarded_lin_iters
                                + info.discarded_lin_iters),
               history=info.history, main_steps=info.steps,
               main_iters=info.total_lin_iters, converged=info.converged,
               functionals=None if fnls is None else fnl_dict(fnls),
               halo_rounds=len(case.flow.exch.rounds))
    flow = case.flow
    be = DistributedBackwardEuler(
        space=flow.space, cfg=dataclasses.replace(cfg.main, bake_mesh=True),
        lin=cfg.linear, nl=cfg.nl_update, flow=flow)
    torch.cuda.synchronize()
    device_counts.enable(dev)
    try:
        t0 = time.perf_counter()
        _, binfo = be.solve(flow.dist_mesh(), case.starter_u,
                            max_steps=J_BAKED_STEPS)
        torch.cuda.synchronize()
        out.update(baked_wall_s=time.perf_counter() - t0,
                   baked_launches=device_launches(dev),
                   baked_history=binfo.history,
                   baked_capture_s=binfo.capture_s,
                   baked_resident=be.device_resident)
    finally:
        device_counts.disable()
    out["graph"] = captured_nodes(dev, next(iter(be._programs[1].values())))
    try:
        with no_host_sync(dev):
            allreduce_sum(comm, torch.ones(91, device=dev))
        out["allreduce_in_no_host_sync"] = "ran"
    except RuntimeError as e:
        out["allreduce_in_no_host_sync"] = f"raised: {e}"[:300]
    return out


def j1_checks(j: dict, g1: dict, g1_hist: list) -> dict:
    """J1 and J1b's line and checks against G1's host-loop run (`g1`, its
    main history `g1_hist`). Returns J1's report with its ms per step."""
    lim = _load(JAX_DIST_RECORD)["limits"]
    hist = j.pop("history")
    bhist = j.pop("baked_history")
    sp = j["split"]

    def ms(wall, n):
        return 1e3 * wall / n if n else None
    g1_main_ms = ms(g1["split"]["main_s"], g1["main_steps"])
    rep = dict(
        j, residuals=[h[2] for h in hist],
        ms_per_starter_step=ms(sp["starter_s"], j["starter_steps"]),
        ms_per_main_step=ms(sp["main_s"], j["main_steps"]),
        ms_per_main_step_net_of_capture=ms(sp["main_s"] - j["main_capture_s"],
                                           j["main_steps"]),
        g1_host_loop_ms_per_main_step=g1_main_ms,
        g1_host_loop_ms_per_starter_step=ms(g1["split"]["starter_s"],
                                            g1["starter_steps"]),
        one_device_pipelined_ms_per_main_step_pr13=ONE_DEVICE_PIPELINED_MS,
        agree_rel=[abs(a[2] - b[2]) / b[2] for a, b in
                   zip(hist[:DIST_AGREE_STEPS], g1_hist)],
        baked=dict(steps=len(bhist), wall_s=j["baked_wall_s"],
                   capture_s=j["baked_capture_s"],
                   iters=[h[4] for h in bhist],
                   rel=[abs(a[2] - b[2]) / b[2] for a, b in zip(bhist,
                                                                 hist)]))
    card_line(f"J1 cylinder {DIST_MESH[0]}x{DIST_MESH[1]} banded, D=1, "
              f"{j['route']}, pipeline", rep)
    check(j["converged"], "J1: the pipelined distributed solve did not "
          "converge")
    check(j["starter_steps"] == g1["starter_steps"],
          f"J1: starter {j['starter_steps']} steps, G1's host loop "
          f"{g1['starter_steps']}")
    for a, b in zip(hist[:DIST_AGREE_STEPS], g1_hist):
        check(abs(a[2] - b[2]) <= lim["agree_res"] * b[2],
              f"J1 main step {a[0]}: residual {a[2]!r} vs G1's {b[2]!r}")
    check(abs(j["main_steps"] - g1["main_steps"]) <= 0.1 * g1["main_steps"],
          f"J1: {j['main_steps']} main steps vs G1's {g1['main_steps']}")
    check(same_functionals(j["functionals"], g1["functionals"], 1e-8,
                           lim["cl_abs"]),
          f"J1 functionals {j['functionals']} vs G1's {g1['functionals']}")
    la, dits = j["launches"], j["device_iters"] + j["discarded_iters"]
    check(dits > 0 and la["banded_apply"] >= dits
          and la["banded_bsgs"] >= dits and la["givens_column"] >= dits
          and la["graph_if"] > 0 and la["row_set"] == 0
          and la["set_if"] == 0,
          f"J1: launches {la} for {dits} Krylov iterations of device-form "
          "steps")
    check(j["baked_resident"] and len(bhist) == J_BAKED_STEPS,
          f"J1b: {len(bhist)} baked steps, device_resident "
          f"{j['baked_resident']}")
    for a, b in zip(bhist, hist):
        check(a[4] == b[4] and abs(a[2] - b[2]) <= J_BAKED_REL * b[2],
              f"J1b main step {a[0]}: {a[4]} Krylov iterations, residual "
              f"{a[2]!r}; J1's {b[4]}, {b[2]!r}")
    bla = j["baked_launches"]
    bits = sum(h[4] for h in bhist)
    check(bla["givens_column"] == bits and bla["graph_if"] > 0,
          f"J1b: launches {bla} for {bits} Krylov iterations")
    return rep


def j2_rank(comm, cfg, flow, u) -> dict:
    """J2 on a rank of G2's D = 2 world (gloo ranks sharing the card: the
    host-staged route): J_STAGED_STEPS steps of _step and of _device_step
    (EAGER control, the Givens and compare-and-set kernels on the card)
    from `u`, each form chained from its own state at the main solve's
    first CFL and rtol, with the host launch counts of the device-form
    steps; then two solves with pipeline set on one flow, one step each,
    their standard output read for STAGED_NOTICE."""
    import dataclasses
    import io
    import torch
    from fvens_tpu_torch.dist.shard import (STAGED_NOTICE,
                                            DistributedBackwardEuler)
    be = DistributedBackwardEuler(space=flow.space, cfg=cfg.main,
                                  lin=cfg.linear, nl=cfg.nl_update, flow=flow)
    dm = flow.dist_mesh()
    lm, bl = dm.to(torch.float32), be._banded(dm)
    cfl, rtol = cfg.main.cfl_init, cfg.linear.rtol
    f = lambda x: torch.tensor(x, dtype=torch.float64, device=comm.device)
    host, dev_rows = [], []
    uh = ud = u
    t0 = time.perf_counter()
    for _ in range(J_STAGED_STEPS):
        uh, res, its = be._step(dm, uh, cfl, rtol, lmesh=lm, bl=bl)
        host.append((res, its))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    zero_counts()
    for _ in range(J_STAGED_STEPS):
        ud, res, its, _ = be._device_step(dm, ud, f(cfl), f(rtol), f(1.0),
                                          lmesh=lm, bl=bl)
        dev_rows.append((float(res), int(its)))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_counts()
    buf = io.StringIO()
    pipe = dataclasses.replace(cfg.main, pipeline=True)
    with contextlib.redirect_stdout(buf):
        for _ in range(2):
            flow.solve_implicit(pipe, lin=cfg.linear, nl=cfg.nl_update, u=u,
                                max_steps=1)
    return dict(rank=comm.rank, route=comm.route,
                host=host, device=dev_rows, host_s=t1 - t0,
                device_s=t2 - t1, launches=launches,
                resident=be.device_resident, restart=cfg.linear.restart,
                notices=buf.getvalue().count(STAGED_NOTICE))


def j2_checks(ranks: list) -> dict:
    """J2's line and checks on the ranks' reports. Returns J2's launches
    (summed over the ranks) and its seconds (rank 0's)."""
    r0 = ranks[0]["j2"]
    launches = {k: sum(r["j2"]["launches"][k] for r in ranks)
                for k in r0["launches"]}
    card_line(f"J2 cylinder {DIST_MESH[0]}x{DIST_MESH[1]} banded, D=2 on one "
              f"card, {r0['route']}, {J_STAGED_STEPS} device-form steps",
              dict(r0, launches=launches))
    check(r0["route"] == "gloo, host-staged" and not r0["resident"],
          f"J2: route {r0['route']}, device_resident {r0['resident']}")
    for k, ((rh, ih), (rd, idv)) in enumerate(zip(r0["host"], r0["device"])):
        check(idv == ih and abs(rd - rh) <= J_STAGED_REL * rh,
              f"J2 step {k + 1}: device form {idv} Krylov iterations, "
              f"residual {rd!r}; _step {ih}, {rh!r}")
    for r in ranks:
        la = r["j2"]["launches"]
        check(la["givens_column"] == J_STAGED_STEPS * r0["restart"]
              and la["cond_set"] >= J_STAGED_STEPS,
              f"J2 rank {r['rank']}: launches {la} for {J_STAGED_STEPS} "
              f"eager steps of FGMRES({r0['restart']})")
    check([r["j2"]["notices"] for r in ranks] == [1, 0],
          f"J2: the staged route's notice printed "
          f"{[r['j2']['notices'] for r in ranks]} times by rank")
    return dict(launches=launches, j_s=r0["j_s"])


def history_rows(info) -> list:
    """A SolveInfo's history as the records' (step, residual, CFL, Krylov
    iterations) rows."""
    return [[int(s), float(r), float(c), int(i)]
            for s, _, r, c, i in info.history]


def history_phase(info) -> dict:
    """One solve of a precision-scheduled run in the layout of
    records/jax_two_phase_history.json."""
    h = history_rows(info)
    return dict(steps=len(h), krylov_iters=sum(r[3] for r in h),
                first_res=h[0][1] if h else None,
                final_res=h[-1][1] if h else None, history=h)


def two_phase_layout(info, entropy=None) -> dict:
    """A precision.TwoPhaseInfo in the layout of
    records/jax_two_phase_history.json's runs: phase A's starter (where
    there is one) and main solve, phase B from its starting CFL (all its
    steps, or `recorded_steps` where its solve was stopped), the totals,
    the final absolute residual and `entropy`."""
    a = dict(main=history_phase(info.a))
    if info.starter is not None:
        a["starter"] = history_phase(info.starter)
    b = dict(cfl_init=info.cfl_b, **history_phase(info.b))
    if not info.b.converged:
        b["recorded_steps"] = info.b.steps
    return dict(gate=info.gate, phase_a=a, phase_b=b, steps=info.steps,
                krylov_iters=info.total_lin_iters,
                converged=bool(info.converged),
                final_abs_res=float(info.finalres), entropy=entropy)


def two_phase_vs_record(name: str, got: dict, rec: dict) -> dict:
    """A precision-scheduled run (`got`, in the layout of
    records/jax_two_phase_history.json's runs) against the record `rec`'s
    run of the same form within the record's limits (the record says why
    each): the comparisons, each *_ok a verdict, and where the two phase-A
    trajectories part (the first main step whose residual differs by more
    than agree_res)."""
    lim, want = rec["limits"], rec["runs"][name]
    ga, wa = got["phase_a"]["main"], want["phase_a"]["main"]
    gh, wh = ga["history"], wa["history"]
    n = lim["agree_steps" if name == "cylinder" else "bench_agree_steps"]
    cfl = [got["phase_b"]["cfl_init"], want["phase_b"]["cfl_init"]]
    out = dict(
        a_steps=[ga["steps"], wa["steps"]], cfl_b=cfl,
        a_parts_at=next((g[0] for g, w in zip(gh, wh)
                         if abs(g[1] - w[1]) > lim["agree_res"] * w[1]),
                        None),
        agree_steps_ok=len(gh) >= n and len(wh) >= n and all(
            g[0] == w[0] and abs(g[3] - w[3]) <= lim["agree_iters"]
            and abs(g[1] - w[1]) <= lim["agree_res"] * w[1]
            for g, w in zip(gh[:n], wh[:n])),
        gate_ok=(got["gate"] == want["gate"]
                 and ga["final_res"] <= got["gate"]))
    bh = got["phase_b"]["history"]
    if name == "bench":
        out["cfl_b_ok"] = cfl[0] == gh[-1][2]
        out["b_ok"] = (len(bh) == want["phase_b"]["recorded_steps"]
                       and all(np.isfinite(r[1]) for r in bh))
        return out
    gs, ws = got["phase_a"]["starter"], want["phase_a"]["starter"]
    out["starter_ok"] = gs["steps"] == ws["steps"] and all(
        abs(g[3] - w[3]) <= lim["agree_iters"]
        for g, w in zip(gs["history"], ws["history"]))
    out["a_steps_ok"] = abs(ga["steps"] - wa["steps"]) <= max(
        1, lim["a_steps"] * wa["steps"])
    out["cfl_b_ok"] = (cfl[0] == gh[-1][2]
                       and abs(cfl[0] - cfl[1]) <= lim["cfl_b"] * cfl[1])
    # phase B: its lowest residual against the JAX runs' spread; converged
    # (to the case's absolute target, 1e-10) or not, as it came
    jmin = max(min(r[1] for r in want["phase_b"]["history"]),
               rec["runs"]["cylinder_blocked"]["min_abs_res"])
    out["b_steps"] = [got["phase_b"]["steps"], want["phase_b"]["steps"]]
    out["b_min_res"] = [min(r[1] for r in bh), jmin]
    out["b_min_ok"] = out["b_min_res"][0] <= lim["b_min"] * jmin
    out["converged"] = bool(got["converged"]
                            and got["final_abs_res"] <= 1e-10)
    ent, ref = got["entropy"], want["single_phase"]["entropy"]
    out["entropy"] = [ent, ref, want["entropy"]]
    out["entropy_ok"] = (not out["converged"]
                         or abs(ent - ref) <= lim["entropy"] * abs(ref))
    return out


# ---------------------------------------------------------------------------
# Phase H: precision scheduling (cases/precision.py) and the distributed
# dry run (entry.py: dryrun_multichip).
# ---------------------------------------------------------------------------
TWO_PHASE_GATE = 1e-3            # H1, H1b: the absolute residual gate
TWO_PHASE_CHECK_MESH = (160, 80)  # H1b: held to JAX_TWO_PHASE_RECORD
JAX_TWO_PHASE_RECORD = "records/jax_two_phase_history.json"
DRYRUN_PARTS = (2, 4)            # H2: ranks sharing cuda:0 over gloo
JAX_DRYRUN_RECORD = "records/jax_dryrun_history.json"


@contextlib.contextmanager
def two_phase_marks(marks: list):
    """Appends the kernels' launch counts to `marks` at each point where a
    precision-scheduled solve synchronises the card: its start, the end of
    phase A and its end (precision._sync, called there and nowhere else on
    the path)."""
    from fvens_tpu_torch.cases import precision
    sync = precision._sync

    def marked(device):
        sync(device)
        marks.append(read_counts())
    precision._sync = marked
    try:
        yield
    finally:
        precision._sync = sync


def count_diff(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in KERNELS}


def phase_a_solvers(dev):
    """make(mixed) -> (phase A's main solver, the f32 mesh) of the 640x320
    cylinder: both precisions of the check are f32, since phase A's state
    is."""
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.cases.casesolvers import SteadyFlowCase, build_space
    case, cm, _ = bigmesh_case.build_case(dev, *bigmesh_case.BIGMESH)
    cm32 = cm.to(torch.float32)

    def make(mixed):
        return SteadyFlowCase(case.cfg)._make_solver(
            build_space(case.cfg), case.cfg.main), cm32
    return make


def two_phase_path(dev, single: dict) -> dict:
    """H1: the banded 640x320 cylinder precision scheduled
    (bigmesh_case.run_solve(two_phase=TWO_PHASE_GATE)), one timed solve
    (no warm-up, to keep the phases within their time),
    counted from just before to just after it. It must converge to 1e-10 with a
    finite state and an entropy error within the record's limit of the
    single-phase solve's (`single`, phase 4's report of the same build);
    per phase of the timed solve, row_set once per Krylov iteration of
    blocked GMRES, the fused K1b at least once and K1 at least once and
    fewer than twice per Krylov iteration. Prints each phase's steps,
    Krylov iterations, wall and ms per main step beside the single-phase
    solve's. Then K1 and K1b against their twins at f32 on phase A's
    operators (the f32 mesh and free stream). Returns the launches."""
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    lim = _load(JAX_TWO_PHASE_RECORD)["limits"]
    torch.cuda.synchronize()
    zero_counts()
    marks = []
    with two_phase_marks(marks):
        u, rep = bigmesh_case.run_solve(dev, two_phase=TWO_PHASE_GATE,
                                        warmup=False)
    torch.cuda.synchronize()
    launches = read_counts()
    check(len(marks) == 3, f"H1: {len(marks)} phase marks, not 3")
    pa, pb = rep["phase_a"], rep["phase_b"]
    per_phase = {"A": count_diff(marks[0], marks[1]),
                 "B": count_diff(marks[1], marks[2])}
    its = {"A": pa["starter_krylov_iters"] + pa["main_krylov_iters"],
           "B": pb["krylov_iters"]}

    def ms(wall, steps):
        return 1e3 * wall / steps if steps else None
    timing = dict(
        phase_a_ms_per_step=ms(pa["main_wall_s"], pa["main_steps"]),
        phase_b_ms_per_step=ms(pb["main_wall_s"], pb["steps"]),
        single_phase_ms_per_step=ms(single["main_wall_s"],
                                    single["main_steps"]),
        single_phase=dict(starter_steps=single["starter_steps"],
                          main_steps=single["main_steps"],
                          main_krylov_iters=single["main_krylov_iters"],
                          wall_s=single["wall_s"],
                          main_wall_s=single["main_wall_s"],
                          entropy=single["entropy"]))
    card_line(f"H1 cylinder 640x320 banded, two-phase gate "
              f"{TWO_PHASE_GATE:g}", dict(
                  rep, **timing, launches=launches,
                  launches_by_phase=per_phase))
    check(rep["converged"] and rep["abs_res"] <= bigmesh_case.TOL_ABS,
          f"H1: the solve did not converge to {bigmesh_case.TOL_ABS}: "
          f"{rep['abs_res']!r}")
    check(u.dtype == torch.float64 and bool(torch.isfinite(u).all()),
          "H1: non-finite state")
    check(pa["abs_res"] <= TWO_PHASE_GATE,
          f"H1: phase A ended at {pa['abs_res']!r}, above the gate")
    check(abs(rep["entropy"] - single["entropy"])
          <= lim["entropy"] * abs(single["entropy"]),
          f"H1: entropy error {rep['entropy']!r} vs the single-phase "
          f"solve's {single['entropy']!r}")
    for ph, la in per_phase.items():
        n = its[ph]
        check(rep["blocked"] and n > 0 and la["row_set"] == n
              and la["banded_bsgs"] >= n
              and n <= la["banded_apply"] < 2 * n,
              f"H1 phase {ph}: launches {la} for {n} Krylov iterations")
    brows, frows = banded_checks(dev, "cylinder 640x320 phase A (f32 state)",
                                 phase_a_solvers(dev), phase_times=False,
                                 precisions=((True, 1e-5),))
    check(all(r["dtype"] == "float32" for r in brows + frows),
          "H1: phase A's operators are not f32")
    return launches


def two_phase_vs_jax(dev) -> dict:
    """H1b: the cylinder at TWO_PHASE_CHECK_MESH precision scheduled, in
    full, and the bench form (naca0012_omesh(160, 80), the gather path as
    bench.py runs it) to phase B's recorded steps, each against
    JAX_TWO_PHASE_RECORD within its limits. Returns the cylinder's
    launches."""
    import torch
    from fvens_tpu_torch.cases import bench_case, bigmesh_case
    from fvens_tpu_torch.cases.casesolvers import build_space
    from fvens_tpu_torch.cases.precision import case_two_phase
    from fvens_tpu_torch.output import entropy_error
    rec = _load(JAX_TWO_PHASE_RECORD)
    case, cm, u0 = bigmesh_case.build_case(dev, *TWO_PHASE_CHECK_MESH)
    torch.cuda.synchronize()
    zero_counts()
    # phase B to its maxiter without the solver's verdict: whether it
    # reaches 1e-10 there turns on rounding (the record's two runs)
    u, info = case_two_phase(case, cm, rec["gate"])(
        u0.to(torch.float32), max_steps=case.cfg.main.maxiter)
    torch.cuda.synchronize()
    launches = read_counts()
    runs = {"cylinder": two_phase_layout(info, float(entropy_error(
        build_space(case.cfg), cm, u)))}
    want_b = rec["runs"]["bench"]["phase_b"]["recorded_steps"]
    solve, _ = bench_case.run_solve(dev, mesh=TWO_PHASE_CHECK_MESH,
                                    two_phase=rec["gate"], banded=False)
    runs["bench"] = two_phase_layout(solve(max_steps=want_b)[1])
    for name, got in runs.items():
        vs = two_phase_vs_record(name, got, rec)
        card_line(f"H1b {name} {TWO_PHASE_CHECK_MESH[0]}x"
                  f"{TWO_PHASE_CHECK_MESH[1]} two-phase vs the JAX record",
                  dict(vs, steps=got["steps"],
                       krylov_iters=got["krylov_iters"],
                       final_abs_res=got["final_abs_res"],
                       **({"launches": launches} if name == "cylinder"
                          else {})))
        check(all(v for k, v in vs.items() if k.endswith("_ok")),
              f"H1b {name}: outside the record's limits: {vs}")
    return launches


def dryrun_vs_record(out: dict, want: dict, lim: dict) -> dict:
    """A dryrun_multichip result against the record's run of the same D:
    the comparisons, each *_ok a verdict."""
    steps = ("implicit", "matrix_free", "banded", "deflated")
    ref = want["mini_solve_history"]["bcsgs"][0][1]
    res = [out["explicit_res"]] + [out["steps"][k]["res"] for k in steps]
    res += [out["mini_solves"][pc]["history"][0][1]
            for pc in ("bcsgs", "ilu0")]
    p = want["parsed"]
    return dict(
        halo_ok=out["halo"] == p["halo"],
        krylov_ok=all(out["steps"][k]["krylov_iters"]
                      == p["steps"][k]["krylov_iters"] for k in steps),
        res_max_rel=max(abs(r - ref) / ref for r in res),
        res_ok=all(abs(r - ref) <= lim["res"] * ref for r in res),
        mini_steps_ok=all(out["mini_solves"][pc]["steps"]
                          == p["mini_solves"][pc]["steps"]
                          for pc in ("bcsgs", "ilu0")),
        lin_iters=[[out["mini_solves"][pc]["lin_iters"],
                    p["mini_solves"][pc]["lin_iters"]]
                   for pc in ("bcsgs", "ilu0")],
        lin_iters_ok=all(
            abs(out["mini_solves"][pc]["lin_iters"]
                - p["mini_solves"][pc]["lin_iters"])
            <= lim["lin_iters"] * p["mini_solves"][pc]["lin_iters"]
            for pc in ("bcsgs", "ilu0")))


def dryrun_shared_card(dev) -> dict:
    """H2: dryrun_multichip(D) for each D of DRYRUN_PARTS on `dev` over
    gloo, host-staged (the worlds at once), each held to the JAX record's
    run of D (dryrun_vs_record), with K1 launched on the banded step.
    Returns the launches by path (summed over the ranks)."""
    from concurrent.futures import ThreadPoolExecutor

    from fvens_tpu_torch.entry import dryrun_multichip
    rec = _load(JAX_DRYRUN_RECORD)
    with ThreadPoolExecutor(len(DRYRUN_PARTS)) as ex:
        jobs = {D: ex.submit(dryrun_multichip, D, device=str(dev),
                             backend="gloo") for D in DRYRUN_PARTS}
        outs = {D: job.result() for D, job in jobs.items()}
    paths = {}
    for D, out in outs.items():
        want = next(r for r in rec["runs"] if r["parsed"]["n_devices"] == D)
        vs = dryrun_vs_record(out, want, rec["limits"])
        card_line(f"H2 dryrun_multichip({D}) on one card, {out['route']}",
                  dict(vs, line=out["line"], route=out["route"],
                       device=out["device"], wall_s=out["wall_s"],
                       launches=out["launches"]))
        check(out["route"] == "gloo, host-staged",
              f"H2 D={D}: route {out['route']}")
        check(all(v for k, v in vs.items() if k.endswith("_ok")),
              f"H2 D={D}: outside the record's limits: {vs}")
        check(out["launches"]["banded_apply"] > 0,
              f"H2 D={D}: the banded step launched no K1: "
              f"{out['launches']}")
        paths[f"H2 dryrun_multichip({D}), cylinder_omesh({8 * D}, 6) f32, "
              f"one card, {out['route']}"] = out["launches"]
    return paths


def precision_phases(dev, paths: dict, single: dict):
    """Phase H: H1 alone (its times are compared), then H1b with H2's
    worlds beside it (their own processes)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    torch.cuda.empty_cache()
    with phase(f"H1: cylinder 640x320 banded, two-phase gate "
               f"{TWO_PHASE_GATE:g} (one timed solve)"):
        paths["H1 cylinder 640x320 banded, two-phase"] = two_phase_path(
            dev, single)
    ni, nj = TWO_PHASE_CHECK_MESH
    with phase(f"H1b/H2: two-phase {ni}x{nj} vs the JAX record; beside it "
               f"dryrun_multichip{DRYRUN_PARTS} on cuda:0, gloo host-staged"):
        with ThreadPoolExecutor(1) as ex:
            h2 = ex.submit(dryrun_shared_card, dev)
            paths[f"H1b cylinder {ni}x{nj} banded, two-phase"] = \
                two_phase_vs_jax(dev)
            paths.update(h2.result())


def move_phase(src: str, dst: str, seconds: float):
    """Take `seconds` out of phase `src` and list them as phase `dst`."""
    PHASES[src] -= seconds
    PHASES[dst] = seconds
    print(f"phase {dst}: {seconds:.2f} s (within {src})", flush=True)


def dist_phases(dev, paths: dict, cli_functionals: dict) -> dict:
    """Phase G: G1 (beside it, in this process, its one-device solve and
    G2's one-device forms), then G2 and G3 with G1's CLI pair beside them
    (its subprocesses run while the worlds do); phase J inside G1's and
    G2's D = 2 worlds. `cli_functionals`: the one-device CLI's at
    DIST_CLI_MESH. Returns J1's report."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    torch.cuda.empty_cache()
    mesh = f"cylinder {DIST_MESH[0]}x{DIST_MESH[1]}"
    g1 = (f"G1: {mesh} banded, DistributedFlowCase on one NCCL rank vs the "
          "one-device classic-GMRES solve")
    with phase(g1):
        starter, launches, parity_ref, j1 = dist_one_rank(dev)
        paths[f"G1 {mesh} banded, D=1, nccl"] = launches
        paths[f"J1 {mesh} banded, D=1, nccl, pipeline"] = j1["launches"]
        paths[f"J1b {mesh} banded, D=1, nccl, bake_mesh, {J_BAKED_STEPS} "
              "main steps"] = j1["baked_launches"]
    move_phase(g1, f"J1/J1b: {mesh} pipelined and baked on G1's NCCL rank",
               j1["j_s"])
    ni, nj = DIST_CLI_MESH
    g2 = (f"G2/G3: D={DIST_PARTS} on cuda:0, gloo host-staged; beside them "
          f"G1's cli --devices 1 {ni}x{nj} + resume")
    with phase(g2):
        with ThreadPoolExecutor(1) as ex:
            cli = ex.submit(dist_cli, cli_functionals)
            shared = dist_shared_card(dev, starter, parity_ref)
            cli.result()
    j2 = shared.pop("j2")
    paths.update(shared)
    paths[f"J2 {mesh} banded, D=2 on one card, gloo, host-staged, "
          f"{J_STAGED_STEPS} device-form steps"] = j2["launches"]
    move_phase(g2, f"J2: {mesh} device-form steps on G2's D=2 world "
               "(host-staged)", j2["j_s"])
    print("phase J", json.dumps(dict(
        seconds=j1["j_s"] + j2["j_s"], j1_j1b_s=j1["j_s"], j2_s=j2["j_s"],
        card=CARD)), flush=True)
    return j1


# ---------------------------------------------------------------------------
# Phase I: device-resident stepping (solver/device_stepping.py): the step
# as one device program, through an FGMRES whose control stays on the card
# ---------------------------------------------------------------------------

STEPPING_MODES = (("pipeline", {"pipeline": True}),
                  ("device_steps=8", {"device_steps": 8}),
                  ("bake_mesh", {"bake_mesh": True}))
JAX_STEPPING_RECORD = "records/jax_stepping_modes_history.json"
STEPPING_CHECK_MESH = (160, 80)
STEPPING_AGREE = 20              # I3: main steps held to the record (1%)
# I1, I2: the 640x320 modes' starter and main steps and Krylov iterations
# within this share of phase 4's single-step solve of the same build (the
# device-controlled GMRES rounds its Krylov update differently, and the
# mixed-precision endgame parts there, as the JAX package's blocked and
# classic runs part at 160x80: 54 and 49 main steps, 1,318 and 850 Krylov
# iterations)
STEPPING_SLACK = 0.25
GIVENS_J = (0, 45, 89)           # I5: iterations of FGMRES(90) timed
IF_NODES = 90                    # I5: IF nodes of the timed graph


def device_launches(dev) -> dict:
    """The launches counted on the card (solver/device_counts), under the
    kernel record's names."""
    from fvens_tpu_torch.solver import device_counts
    n = device_counts.read(dev)
    return {"banded_apply": n["banded_apply"], "banded_bsgs": n["bsgs_apply"],
            "banded_bsgs_cluster": n["bsgs_cluster"],
            "row_set": n["row_set"], "givens_column": n["givens_column"],
            "graph_if": n["graph_if"], "set_if": n["set_if"],
            "cond_set": n["cond_set"]}


def traced_busy(dev, fn) -> dict:
    """fn() under torch.profiler: the traced wall (fn ends in a
    synchronize), the device time of its kernels and their share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fvens_tpu_torch.cases.profile_step import _device_us, _on_device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ka = [e for e in prof.key_averages() if _on_device(e)]
    busy = sum(_device_us(e) for e in ka) / 1e3
    return dict(traced_wall_ms=wall, device_busy_ms=busy,
                device_busy_share=busy / wall if wall else None,
                kernels=sum(e.count for e in ka))


_TRACE_STATE = {}                 # the starter's state the traces start at


def step_traces(dev, case, cm, name: str) -> dict:
    """Main steps from the starter's state at the main CFL, traced on the
    case `name` ran (its main solver and programs, captured by its solve):
    for the pipeline the host-controlled step and the captured step
    (StepProgram), for device_steps one chunk (8 steps). The first call
    runs the starter; the next start from its state."""
    import torch
    from fvens_tpu_torch.cases.casesolvers import build_space, initial_state
    solver = case._main_solver
    if "u" not in _TRACE_STATE:
        _TRACE_STATE["u"] = case.execute_starter(
            cm, initial_state(build_space(case.cfg), cm))
    u = _TRACE_STATE["u"]
    cfl, rtol = case.cfg.main.cfl_init, 0.1
    lmesh, bl = cm.to(torch.float32), solver._banded(cm)
    out = {}

    def traced(name, fn):
        """traced_busy of fn, which returns its Krylov iterations, with
        them and the device ms per iteration."""
        its = []
        rec = traced_busy(dev, lambda: its.append(fn()))
        rec.update(krylov_iters=its[0],
                   device_ms_per_krylov_iter=rec["device_busy_ms"] / its[0])
        out[name] = rec
    if name == "pipeline":
        traced("host-controlled step", lambda: solver._step(
            cm, u, cfl, rtol, lmesh=lmesh, bl=bl)[2])
        prog = solver._program("step", cm, lmesh, bl, u)
        traced("captured step", lambda: int(prog(u, cfl, rtol, 1.0)[2]))
        return out
    chunk = solver._program("chunk", cm, lmesh, bl, u)
    state = dict(res_best=float("inf"), stall=0, cfl=cfl, cfl_cap=1e300,
                 rtol=rtol, rtol_floor=solver.lin.rtol, raise_relres=0.0,
                 res=1.0, resold=1.0, initres=1.0)
    du = torch.zeros_like(u)
    steps = []

    def run_chunk():
        carry = chunk.run(u, du, u, **state)[0]
        steps.append(carry["nsteps"])
        return carry["iters"]
    traced("chunk", run_chunk)
    out["chunk"]["steps"] = steps[0]
    return out


@contextlib.contextmanager
def solve_counts(dev, marks: dict):
    """Inside: each SteadyFlowCase starter and main solve writes into
    `marks` ("starter", "main"; the last solve's kept) the launches
    counted on the card across it (solver/device_counts must be on) and
    its SolveInfo."""
    import torch
    from fvens_tpu_torch.cases.casesolvers import SteadyFlowCase
    saved = SteadyFlowCase.execute_starter, SteadyFlowCase.execute_main

    def counted(name, fn, info):
        def run(self, *a, **k):
            torch.cuda.synchronize()
            n0 = device_launches(dev)
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            n1 = device_launches(dev)
            marks[name] = ({key: n1[key] - n0[key] for key in n1},
                           info(self, out))
            return out
        return run
    SteadyFlowCase.execute_starter = counted(
        "starter", saved[0], lambda case, out: case.starter_info)
    SteadyFlowCase.execute_main = counted("main", saved[1],
                                          lambda case, out: out[1])
    try:
        yield
    finally:
        SteadyFlowCase.execute_starter, SteadyFlowCase.execute_main = saved


def per_step(counts: dict, info) -> dict:
    """A solve's IF nodes reached, set-condition and compare-and-set
    launches and Givens updates per accepted step, beside its Krylov
    iterations per step (those of discarded speculative steps included, as
    in the counts) and the limit on the nodes, 2 x iterations + 15."""
    n = max(info.steps, 1)
    its = (info.device_lin_iters + info.discarded_lin_iters) / n
    return dict(steps=info.steps, device_krylov_iters_per_step=its,
                if_nodes_per_step=counts["graph_if"] / n,
                if_node_limit_per_step=2 * its + 15,
                set_if_per_step=counts["set_if"] / n,
                cond_set_per_step=counts["cond_set"] / n,
                givens_per_step=counts["givens_column"] / n)


def stepping_path(dev, name: str, stepping: dict, single: dict,
                  warmup: bool, keep: dict) -> tuple:
    """I1/I2: bigmesh_case.run_solve at 640x320 under `stepping`, with the
    launches counted on the card from just before to just after (both
    solves where `warmup`). Checks: converged to 1e-10 with a finite state;
    starter and main steps and Krylov iterations within STEPPING_SLACK of
    phase 4's single-step solve (`single`); per Krylov iteration one
    row_set append and one Givens update of a device-form step, K1b at
    least once and K1 at least once and fewer than twice (the iterations
    of the pipeline's discarded speculative steps included; a program's
    eager warm-up before its capture is not counted). Traces main
    steps of the case (step_traces). `keep` receives the case and its mesh.
    Returns (report, timing and traces, launches)."""
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    from fvens_tpu_torch.solver import device_counts
    marks = {}
    torch.cuda.synchronize()
    device_counts.enable(dev)
    try:
        with solve_counts(dev, marks):
            u, rep = bigmesh_case.run_solve(dev, warmup=warmup,
                                            stepping=stepping, keep=keep)
        torch.cuda.synchronize()
        launches = device_launches(dev)
    finally:
        device_counts.disable()
    its, dits = rep["krylov_iters_all"], rep["device_krylov_iters_all"]
    # the pipeline's speculative steps discarded at convergence ran too
    ran = its + rep["discarded_krylov_iters_all"]
    dran = dits + rep["discarded_krylov_iters_all"]
    net = rep["main_wall_s"] - rep["main_capture_s"]

    def ms(wall, n):
        return 1e3 * wall / n if n else None
    timing = dict(
        ms_per_main_step=ms(rep["main_wall_s"], rep["main_steps"]),
        ms_per_main_step_net_of_capture=ms(net, rep["main_steps"]),
        ms_per_krylov_iter=ms(net, rep["main_krylov_iters"]),
        single_step=dict(
            starter_steps=single["starter_steps"],
            starter_krylov_iters=single["starter_krylov_iters"],
            main_steps=single["main_steps"],
            main_krylov_iters=single["main_krylov_iters"],
            ms_per_main_step=ms(single["main_wall_s"], single["main_steps"]),
            ms_per_krylov_iter=ms(single["main_wall_s"],
                                  single["main_krylov_iters"])))
    if name != "bake_mesh":
        with phase(f"I: traced main steps ({name})"):
            timing["traces"] = step_traces(dev, keep["case"], keep["mesh"],
                                           name)
    steps = {k: per_step(*marks[k]) for k in ("starter", "main")}
    timing["per_step"] = steps
    card_line(f"I cylinder 640x320 banded, {name}"
              + (" (warm-up + timed)" if warmup else " (one timed solve)"),
              dict(rep, **timing, launches=launches))
    print(f"I {name} per step (timed solve)", json.dumps(steps), flush=True)
    check(rep["converged"] and rep["abs_res"] <= bigmesh_case.TOL_ABS,
          f"I {name}: the solve did not converge to {bigmesh_case.TOL_ABS}: "
          f"{rep['abs_res']!r}")
    check(u.dtype == torch.float64 and bool(torch.isfinite(u).all())
          and np.isfinite(rep["entropy"]), f"I {name}: non-finite state")
    for key in ("starter_steps", "starter_krylov_iters", "main_steps",
                "main_krylov_iters"):
        check(abs(rep[key] - single[key]) <= STEPPING_SLACK * single[key],
              f"I {name}: {key} {rep[key]} not within "
              f"{STEPPING_SLACK:.0%} of the single-step solve's "
              f"{single[key]}")
    check(dits > 0 and launches["givens_column"] == dran
          and launches["row_set"] == ran and launches["banded_bsgs"] >= ran
          and ran <= launches["banded_apply"] < 2 * ran
          and launches["graph_if"] >= dran and launches["cond_set"] >= dran
          and launches["set_if"] == 0,
          f"I {name}: launches {launches} for {ran} Krylov iterations run, "
          f"{dran} of them in device-form steps "
          f"({rep['discarded_krylov_iters_all']} in discarded ones)")
    main = steps["main"]
    check(main["if_nodes_per_step"] <= main["if_node_limit_per_step"],
          f"I {name}: {main['if_nodes_per_step']} IF nodes reached per main "
          f"step, above 2 x iterations + 15 = "
          f"{main['if_node_limit_per_step']}")
    return rep, timing, launches


def stepping_vs_record(dev) -> dict:
    """I3: the 160x80 cylinder under each mode (its classic GMRES path,
    which that size takes by itself) against the JAX package's CPU runs:
    pipeline against the classic run of JAX_BIGMESH_RECORD (the JAX
    package's pipelined steps are its single steps), device_steps = 8 and
    bake_mesh against JAX_STEPPING_RECORD. The starter's steps exactly and
    its Krylov iterations within 2%, the first STEPPING_AGREE main steps'
    residuals within 1%; the main steps and Krylov iterations within 10%
    of the range of the JAX package's runs of this mesh (blocked and
    classic GMRES, each option: 49-54 steps, 850-1,318 iterations; the
    mixed-precision endgame parts near the f32 floor, so no run is held
    to one of them). Returns the host launch counts."""
    import torch
    from fvens_tpu_torch.cases import bigmesh_case
    mesh = f"cylinder_omesh{STEPPING_CHECK_MESH}"
    classic = next(r for r in cylinder_record(mesh)
                   if not r["blocked_gmres"])
    recs = {"pipeline": classic}
    for r in _load(JAX_STEPPING_RECORD)["runs"]:
        recs[f"{r['option']}={r['value']}" if r["option"] == "device_steps"
             else r["option"]] = r
    runs = cylinder_record(mesh) + _load(JAX_STEPPING_RECORD)["runs"]
    span = {k: (min(r["main"][k] for r in runs),
                max(r["main"][k] for r in runs))
            for k in ("steps", "krylov_iters")}
    n0 = read_counts()
    out = {}
    for name, stepping in STEPPING_MODES:
        rec = recs[name]
        case, cm, u0 = bigmesh_case.build_case(dev, *STEPPING_CHECK_MESH,
                                               stepping=stepping)
        u, info = case.solve(cm, u0)
        torch.cuda.synchronize()
        st = case.starter_info
        got = dict(starter=(st.steps, st.total_lin_iters),
                   main=(info.steps, info.total_lin_iters),
                   final=info.finalres)
        want = dict(starter=(rec["starter"]["steps"],
                             rec["starter"]["krylov_iters"]),
                    main=(rec["main"]["steps"], rec["main"]["krylov_iters"]))
        out[name] = dict(got, record=want)
        print(f"I3 {mesh} {name}: {json.dumps(out[name])}", flush=True)
        check(info.converged and bool(torch.isfinite(u).all()),
              f"I3 {name}: the {mesh} solve did not converge")
        check(st.steps == want["starter"][0]
              and abs(st.total_lin_iters - want["starter"][1])
              <= 0.02 * want["starter"][1],
              f"I3 {name}: the starter departs from the JAX package's")
        ref = rec["main"]["history"]
        check(len(info.history) >= STEPPING_AGREE,
              f"I3 {name}: only {len(info.history)} main steps")
        for k in range(STEPPING_AGREE):
            res_ref, h = ref[k][1], info.history[k]
            check(abs(h[2] - res_ref) <= 0.01 * res_ref,
                  f"I3 {name} main step {k + 1}: residual {h[2]!r} vs "
                  f"{res_ref!r}")
        for got_n, key in ((info.steps, "steps"),
                           (info.total_lin_iters, "krylov_iters")):
            lo, hi = span[key]
            check(0.9 * lo <= got_n <= 1.1 * hi,
                  f"I3 {name}: main {key} {got_n} not within 10% of the "
                  f"JAX package's {lo}-{hi}")
    return count_diff(n0, read_counts())


def stepping_cli(dev) -> dict:
    """I4: the port's CLI with --pipeline on the committed cylinder ctrl at
    CHECK_MESH, against the JAX package's CLI run of the same files
    (JAX_CLI_RECORD, unpipelined: the JAX package's pipelined steps are its
    single steps): the starter's steps, the first AGREE_STEPS main steps
    (Krylov iterations within 1, residuals within 1%), the totals within
    10%, the functionals within 1e-6."""
    import tempfile
    rec = _load(JAX_CLI_RECORD)
    ni, nj = CHECK_MESH
    n0 = read_counts()
    with tempfile.TemporaryDirectory() as tmp:
        msh = os.path.join(tmp, "cylinder.msh")
        hist = os.path.join(tmp, "history.jsonl")
        write_cylinder_msh(msh, ni, nj)
        run = run_cli([CLI_CTRL, "--mesh_file", msh, "-options_file",
                       CLI_SOLVERC, "--device", dev.type, "--log_every", "1",
                       "--pipeline", "--history", hist],
                      f"cli_{ni}x{nj}_pipeline.log")
        rows = read_jsonl(hist) if run["rc"] == 0 else []
    check(run["rc"] == 0, f"I4: the --pipeline CLI run exited {run['rc']}")
    ref = rec["main"]
    print(f"I4 cli {ni}x{nj} --pipeline: starter "
          f"{len(run['starter_iters'])} steps, main {run['main_steps']} / "
          f"{run['main_iters']}, wall {run['wall_s']:.2f} s; the JAX "
          f"package's: starter {rec['starter']['steps']}, main "
          f"{ref['steps']} / {ref['krylov_iters']}", flush=True)
    check(len(run["starter_iters"]) == rec["starter"]["steps"],
          "I4: the starter departs from the JAX package's")
    check(len(rows) >= AGREE_STEPS, f"I4: only {len(rows)} main steps")
    for r, q in zip(rows[:AGREE_STEPS], ref["history"]):
        check(abs(r["lin_iters"] - q["lin_iters"]) <= 1
              and abs(r["absres"] - q["absres"]) <= 0.01 * q["absres"],
              f"I4 main step {r['step']}: iterations {r['lin_iters']} vs "
              f"{q['lin_iters']}, residual {r['absres']!r} vs "
              f"{q['absres']!r}")
    for got, key in ((run["main_steps"], "steps"),
                     (run["main_iters"], "krylov_iters")):
        check(abs(got - ref[key]) <= 0.1 * ref[key],
              f"I4: main {key} {got} not within 10% of {ref[key]}")
    check(same_functionals(run, rec["functionals"], 1e-6),
          "I4: the functionals differ from the JAX package's")
    return count_diff(n0, read_counts())


def givens_checks(dev) -> list:
    """I5: the Givens kernel against its plain twin on the card, bit for bit,
    at f32 (the main path's Krylov dtype) and f64, at iterations GIVENS_J of
    FGMRES(90), with a NaN column and a dead call; each timed (a call: CUDA
    events, median of TIMED_RUNS; device time: profile_step.device_ms; the
    twin on the card's tensors too; less the predicate's reset)."""
    import torch
    from fvens_tpu_torch.cases.profile_step import device_ms
    from fvens_tpu_torch.solver import givens_kernels as gk
    rng = np.random.default_rng(4)
    m = 90
    rows = []
    for dtype in (torch.float32, torch.float64):
        for j in GIVENS_J:
            for nan, live in ((False, True), (True, True), (False, False)):
                theta = rng.uniform(-np.pi, np.pi, m)
                cs, sn = np.cos(theta), np.sin(theta)
                cs[j:] = sn[j:] = 0
                g = np.zeros(m + 1)
                g[:j + 1] = rng.standard_normal(j + 1)
                h = rng.standard_normal(j + 1) * 10.0 ** rng.uniform(
                    -4, 4, j + 1)
                if nan:
                    h[j // 2] = np.nan
                t = lambda a: torch.tensor(np.asarray(a), dtype=dtype,
                                           device=dev)
                st = dict(h=t(h), hn=t(abs(rng.standard_normal())),
                          H=torch.full((m + 1, m), 7.0, dtype=dtype,
                                       device=dev),
                          cs=t(cs), sn=t(sn), g=t(g), res=t(-1.0),
                          tol=t(abs(g[0]) * 1e-3),
                          live=torch.tensor(live, device=dev),
                          iters=torch.tensor(3, dtype=torch.int32,
                                             device=dev))
                names = ("h", "hn", "H", "cs", "sn", "g", "res", "tol",
                         "live", "iters")
                cpu = {k: v.cpu() for k, v in st.items()}
                gk.givens_column(st["h"], st["hn"], j,
                                 *(st[k] for k in names[2:]))
                gk.givens_plain(cpu["h"], cpu["hn"], j,
                                *(cpu[k] for k in names[2:]))
                torch.cuda.synchronize()
                for k in ("H", "cs", "sn", "g", "res", "live", "iters"):
                    check(np.array_equal(st[k].cpu().numpy(),
                                         cpu[k].numpy(), equal_nan=True),
                          f"givens_column differs from its twin: {k}, "
                          f"j={j}, {dtype}, nan={nan}, live={live}")
                if nan or not live:
                    continue
                st["live"].fill_(True)
                args = [st["h"], st["hn"], j] + [st[k] for k in names[2:]]

                def kern(a=args):
                    a[-2].fill_(True)
                    gk.givens_column(*a)

                def plain(a=args):
                    a[-2].fill_(True)
                    gk.givens_plain(*a)
                fill = event_ms(lambda a=args: a[-2].fill_(True))
                fill_dev = device_ms(lambda a=args: a[-2].fill_(True), n=200)
                isz = st["H"].element_size()
                # each input read once (h, hn, cs and sn up to j, g[j],
                # tol, live, iters), each output written once (H's column,
                # cs[j], sn[j], g[j:j+2], res, live, iters)
                nbytes = (j + 2 + 2 * j + 2) * isz + 5 + (m + 1 + 5) * isz + 5
                row = dict(dtype=str(dtype)[6:], j=j, m=m, max_abs_err=0.0,
                           ms=event_ms(kern) - fill,
                           device_ms=device_ms(kern, n=200) - fill_dev,
                           plain_ms=event_ms(plain) - fill)
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes, 6 * j + 12, row["dtype"])
                rows.append(row)
                print("givens_column check", json.dumps(row), flush=True)
    return rows


def graph_if_checks(dev) -> dict:
    """I5: IF_NODES IF nodes in each of two forms, replayed with their
    condition true and false (each body ran exactly when it held), timed
    per node in this call: the generic form, GraphControl.run_if (a
    set-condition kernel in front of each node, the body one small add),
    and the chained form the Krylov chain uses, each node's handle set
    where its predicate is computed (the first by the compare-and-set
    kernel, each body one compare-and-set launch that sets the next node
    and writes a flag). Beside them the host's way of deciding, reading the
    predicate back (a synchronizing .item() per decision)."""
    import torch
    from fvens_tpu_torch.solver.device_stepping import capture_graph
    from fvens_tpu_torch.solver.graph_if import GREATER, cond_set
    pred = torch.tensor(True, device=dev)
    y = torch.zeros((), device=dev)

    def body(ctl):
        for _ in range(IF_NODES):
            ctl.run_if(pred, lambda _: y.add_(1.0))
        return ()
    graph, pool, _ = capture_graph(dev, body)
    graph.replay()
    pred.fill_(False)
    graph.replay()
    torch.cuda.synchronize()
    err = abs(float(y) - IF_NODES)
    check(err == 0, f"graph_if: {float(y)} bodies ran, not {IF_NODES}")
    dead = event_ms(graph.replay) / IF_NODES
    pred.fill_(True)
    live = event_ms(graph.replay) / IF_NODES

    flag = torch.ones((), device=dev)
    zero = torch.zeros((), device=dev)
    ran = torch.zeros(IF_NODES, dtype=torch.bool, device=dev)

    def chained(ctl):
        hs = [ctl.handle() for _ in range(IF_NODES)]
        cond_set(GREATER, flag, zero, handle=hs[0])
        for i, h in enumerate(hs):
            nxt = hs[i + 1] if i + 1 < IF_NODES else None
            ctl.node(h, lambda _, i=i, nxt=nxt: cond_set(
                GREATER, flag, zero, out=ran[i], handle=nxt))
        return ()
    cgraph, cpool, _ = capture_graph(dev, chained)
    cgraph.replay()
    torch.cuda.synchronize()
    n_live = int(ran.sum())
    ran.zero_()
    flag.zero_()
    cgraph.replay()
    torch.cuda.synchronize()
    n_dead = int(ran.sum())
    check(n_live == IF_NODES and n_dead == 0,
          f"graph_if chained: {n_live} bodies ran with the chain live, "
          f"{n_dead} with it dead (want {IF_NODES}, 0)")
    chained_dead = event_ms(cgraph.replay) / IF_NODES
    flag.fill_(1.0)
    chained_live = event_ms(cgraph.replay) / IF_NODES

    def host_decision():
        if pred.item():
            y.add_(1.0)
    t = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        host_decision()
        t.append((time.perf_counter() - t0) * 1e3)
    rec = dict(nodes=IF_NODES, max_abs_err=err, ms=chained_dead,
               live_node_ms=chained_live, set_kernel_dead_node_ms=dead,
               set_kernel_live_node_ms=live, plain_ms=float(np.median(t)),
               plain="the host's decision: pred.item() and a launch")
    rec["bound_ms"], rec["bound_by"] = bound(1, 0, "float32")
    print("graph_if check", json.dumps(rec), flush=True)
    del graph, pool, cgraph, cpool
    return rec


def straddling(rng, dtype, n=16) -> list:
    """(a, b) pairs of the blocked path's test a < 0.7 b at `dtype`: b
    where 0.7 b rounds otherwise at f32 than at f64 (at f64: random b),
    a the product rounded at dtype, its two neighbours and (f32) the
    product rounded from f64; zeros, infinities and NaNs."""
    npdt = np.float32 if dtype == "float32" else np.float64
    b = (rng.standard_normal(20000)
         * 10.0 ** rng.uniform(-3, 3, 20000)).astype(npdt)
    p = npdt(0.7) * b
    wide = (0.7 * b.astype(np.float64)).astype(npdt)
    pick = np.flatnonzero(p != wide)[:n] if npdt is np.float32 \
        else np.arange(n)
    pairs = []
    for i in pick:
        for a in (p[i], np.nextafter(p[i], npdt(-np.inf)),
                  np.nextafter(p[i], npdt(np.inf)), wide[i]):
            pairs.append((a, b[i]))
    special = (0.0, -0.0, np.inf, -np.inf, np.nan, 1.0)
    pairs += [(npdt(x), npdt(y)) for x in special for y in special]
    return pairs


def cond_set_checks(dev) -> dict:
    """I5: the compare-and-set kernel (graph_if.cond_set) against its twin
    (cond_plain) and against the torch expressions it replaces, bit for
    bit, at f32 and f64: hn < 0.7 * wn0 on values that straddle the
    product's rounding, beta > tol and res > tol on the same pairs, and
    flag == 0 on int32 flags and float zeros; timed (f32, LESS: a call,
    its device time, the twin and the torch form on the card) beside its
    bound."""
    import torch
    from fvens_tpu_torch.cases.profile_step import device_ms
    from fvens_tpu_torch.solver.graph_if import (GREATER, LESS, ZERO,
                                                 cond_plain, cond_set)
    rng = np.random.default_rng(11)
    n = 0
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        for a, b in straddling(rng, dname):
            ta = torch.tensor(a, dtype=dtype, device=dev)
            tb = torch.tensor(b, dtype=dtype, device=dev)
            for op, want in ((LESS, ta < 0.7 * tb), (GREATER, ta > tb),
                             (ZERO, ta == 0)):
                got = cond_set(op, ta, tb, 0.7 if op == LESS else 1.0)
                twin = cond_plain(op, ta, tb, 0.7 if op == LESS else 1.0)
                n += 1
                check(bool(got) == bool(twin) == bool(want),
                      f"cond_set: op {op} at {dname} on ({a!r}, {b!r}): "
                      f"kernel {bool(got)}, twin {bool(twin)}, torch "
                      f"{bool(want)}")
    for f in (0, 1, 2, 3, -1):
        tf = torch.tensor(f, dtype=torch.int32, device=dev)
        check(bool(cond_set(ZERO, tf)) == (f == 0),
              f"cond_set: int32 flag {f} == 0")
        n += 1
    hn = torch.tensor(0.69, dtype=torch.float32, device=dev)
    wn0 = torch.tensor(1.0, dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.bool, device=dev)
    kern = lambda: cond_set(LESS, hn, wn0, 0.7, out=out)
    rec = dict(dtype="float32", cases=n, max_abs_err=0.0, ms=event_ms(kern),
               device_ms=device_ms(kern, n=200),
               plain_ms=event_ms(lambda: cond_plain(LESS, hn, wn0, 0.7)),
               torch_form_ms=event_ms(lambda: hn < 0.7 * wn0),
               torch_form="hn < 0.7 * wn0 (two launches)")
    # two scalars read, one bool written; one product and one comparison
    rec["bound_ms"], rec["bound_by"] = bound(2 * 4 + 1, 2, "float32")
    print("cond_set check", json.dumps(rec), flush=True)
    return rec


def chain_nodes(k: int, n: int, group: int) -> int:
    """The IF nodes a Krylov chain of n iterations in groups of `group`
    reaches when it stops after k: every group's node, and the inner nodes
    of the groups that began live."""
    live_groups = -(-k // group)
    return -(-n // group) + min(n, live_groups * group) - live_groups


def chain_checks(dev) -> dict:
    """I5: a cycle's Krylov chain as gmres_device captures it
    (NodeControl.run_chain: groups of graph_if.GROUP under group nodes,
    iteration j + 1's node decided by iteration j's Givens update), on
    IF_NODES iterations of one Givens update each at f32, with a tolerance
    that stops it part way: replayed, exactly the first k bodies ran (k as
    the twin's run of the same updates gives it), the Krylov state equals
    the twin's bit for bit, and the IF nodes reached, counted on the card,
    are chain_nodes(k); the compare-and-set kernel launched once and no
    set-condition kernel."""
    import torch
    from fvens_tpu_torch.solver import device_counts
    from fvens_tpu_torch.solver import givens_kernels as gk
    from fvens_tpu_torch.solver.device_stepping import capture_graph
    from fvens_tpu_torch.solver.graph_if import GREATER, GROUP
    m = IF_NODES
    rng = np.random.default_rng(7)
    h, hn = rng.standard_normal(m + 1), abs(rng.standard_normal())
    names = ("H", "cs", "sn", "g", "res", "live", "iters")
    args = ("H", "cs", "sn", "g", "res", "tol", "live", "iters")

    def state(device, tol):
        t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt,
                                                     device=device)
        g = np.zeros(m + 1)
        g[0] = 1.0
        return dict(h=t(h), hn=t(hn), H=torch.zeros((m + 1, m),
                                                    device=device),
                    cs=torch.zeros(m, device=device),
                    sn=torch.zeros(m, device=device), g=t(g), res=t(np.inf),
                    tol=t(tol), beta=t(1.0), live=t(True, torch.bool),
                    iters=t(0, torch.int32))

    def twin(tol):
        """The twin's run of the m updates (dead ones change nothing), and
        the residual after each."""
        st, res = state("cpu", tol), []
        for j in range(m):
            gk.givens_plain(st["h"][:j + 1], st["hn"], j,
                            *(st[k] for k in args))
            res.append(float(st["res"]))
        return st, res
    # the tolerance stops the chain at about half its iterations
    tol = twin(0.0)[1][m // 2 - 1]
    want = twin(tol)[0]
    k = int(want["iters"])
    check(1 < k < m, f"chain check: the twin ran {k} of {m} iterations")
    st = state(dev, tol)
    init = {key: v.clone() for key, v in st.items()}
    ran = torch.zeros(m, dtype=torch.int32, device=dev)

    def iteration(j, nxt, _):
        ran[j].add_(1)
        gk.givens_column(st["h"][:j + 1], st["hn"], j,
                         *(st[key] for key in args), next_cond=nxt)

    def body(ctl):
        ctl.run_chain(m, GREATER, st["beta"], st["tol"], st["live"],
                      iteration)
        return ()
    torch.cuda.synchronize()
    device_counts.enable(dev)
    try:
        graph, pool, _ = capture_graph(dev, body)
        for key, v in init.items():
            st[key].copy_(v)
        device_counts.zero()
        graph.replay()
        torch.cuda.synchronize()
        counts = device_launches(dev)
    finally:
        device_counts.disable()
    ran_h = ran.cpu().numpy()
    check(ran_h.tolist() == [1] * k + [0] * (m - k),
          f"chain check: bodies ran {ran_h.tolist()}, want the first {k}")
    for key in names:
        check(np.array_equal(st[key].cpu().numpy(), want[key].numpy(),
                             equal_nan=True),
              f"chain check: {key} differs from the twin's")
    nodes = chain_nodes(k, m, GROUP)
    check(counts["graph_if"] == nodes and counts["givens_column"] == k
          and counts["cond_set"] == 1 and counts["set_if"] == 0,
          f"chain check: counts {counts}, want {nodes} IF nodes, {k} Givens "
          "updates, one compare-and-set, no set-condition kernel")
    rec = dict(iterations=m, live=k, group=GROUP, nodes_reached=nodes,
               dead_nodes=nodes - k, counts=counts)
    print("graph_if chain check", json.dumps(rec), flush=True)
    del graph, pool
    return rec


def gmres_capture_check(dev, solver, cm) -> dict:
    """I5: gmres_device on the 640x320 cylinder's step-0 banded operators
    (`solver`, the case's main solver, on its mesh `cm`: f32, FGMRES(90)
    at rtol 1e-2, its blocked path), eager (masked) and captured (the
    chained IF nodes) on the card: x, the Krylov iterations and the
    residual equal bit for bit; the captured solve timed per Krylov
    iteration."""
    import torch
    from fvens_tpu_torch.cases.casesolvers import initial_state
    from fvens_tpu_torch.solver import linear
    from fvens_tpu_torch.solver.device_stepping import capture_graph
    u0 = initial_state(solver.space, cm)
    lmesh, bl = cm.to(torch.float32), solver._banded(cm)
    _, lrhs, ops = solver.step_operators(cm, u0, solver.cfg.cfl_init,
                                         lmesh, bl)
    mv, pc = solver._linear_operators(ops)
    m = solver.lin.restart
    rtol = torch.tensor(1e-2, dtype=torch.float64, device=dev)
    x0 = torch.zeros_like(lrhs)
    ws = linear.KrylovWorkspace(lrhs.numel(), m, lrhs.dtype, dev, True)
    xe, ite, re = linear.gmres_device(mv, lrhs, x0, pc, rtol, m, m, ws=ws)
    xe, ite, re = xe.clone(), int(ite), float(re)
    graph, pool, out = capture_graph(dev, lambda ctl: linear.gmres_device(
        mv, lrhs, x0, pc, rtol, m, m, ws=ws, ctl=ctl))
    graph.replay()
    torch.cuda.synchronize()
    rec = dict(n=lrhs.numel(), dtype=str(lrhs.dtype)[6:], restart=m,
               iterations=int(out[1]), eager_iterations=ite,
               relres=float(out[2]), eager_relres=re,
               x_equal=bool(torch.equal(out[0], xe)))
    check(rec["iterations"] == ite > 0 and rec["relres"] == re
          and rec["x_equal"],
          f"gmres_device captured vs eager on the 640x320 step-0 operators: "
          f"{rec}")
    rec["ms_per_krylov_iter"] = event_ms(graph.replay, runs=10) / ite
    print("gmres_device capture check", json.dumps(rec), flush=True)
    del graph, pool
    return rec


def stepping_phases(dev, paths: dict, single: dict) -> dict:
    """Phase I. Returns the Givens and IF-node measurements and I1's
    launches for the kernel record."""
    import torch
    torch.cuda.empty_cache()
    with phase("I5: givens_column, cond_set and graph_if against their "
               "twins"):
        grows = givens_checks(dev)
        ifrec = graph_if_checks(dev)
        condrec = cond_set_checks(dev)
        chain_checks(dev)
    reports = {}
    for name, stepping in STEPPING_MODES:
        warmup = name == "pipeline"
        title = f"I cylinder 640x320 banded, {name}"
        keep = {}
        with phase(f"I1/I2: {title}" + (" (warm-up + timed)" if warmup
                                        else "")):
            rep, timing, launches = stepping_path(dev, name, stepping,
                                                  single, warmup, keep)
        if warmup:
            with phase("I5: gmres_device captured vs eager, 640x320"):
                gmres_capture_check(dev, keep["case"]._main_solver,
                                    keep["mesh"])
        paths[title] = launches
        reports[name] = dict(timing, main_wall_s=rep["main_wall_s"],
                             capture_s=rep["capture_s"],
                             main_steps=rep["main_steps"],
                             main_krylov_iters=rep["main_krylov_iters"])
        torch.cuda.empty_cache()
    with phase(f"I3: the modes at {STEPPING_CHECK_MESH[0]}x"
               f"{STEPPING_CHECK_MESH[1]} vs the JAX records"):
        paths["I3 cylinder 160x80 modes"] = stepping_vs_record(dev)
    with phase("I4: cli --pipeline vs the JAX record"):
        paths["I4 cli 160x80 --pipeline"] = stepping_cli(dev)
    print("I summary", json.dumps(dict(modes=reports, card=CARD)),
          flush=True)
    return dict(givens=grows, graph_if=ifrec, cond_set=condrec,
                launches=paths["I cylinder 640x320 banded, pipeline"],
                i1=reports["pipeline"])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this test runs only on a GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    global CARD
    CARD = smi
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fvens_tpu_torch.cases.bench_case import bench_solver

    dev = torch.device("cuda", 0)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)

    with phase("build"):
        build_kernels()
    with phase("kernel checks"):
        brows, frows = banded_checks(dev, "cylinder 640x320",
                                     cylinder_solvers(dev))
        b2, f2 = banded_checks(dev, "bench 160x80",
                               lambda mixed: bench_solver(dev, mixed=mixed))
        brows, frows = brows + b2, frows + f2
        for n in HEAT_N:
            b3, f3 = banded_checks(dev, f"heat {n}x{n}", heat_solvers(dev, n),
                                   heat_state, phase_times=False)
            brows, frows = brows + b3, frows + f3
        rrows = rowset_checks(dev)
        srows = slot_checks(dev)
        from fvens_tpu_torch.cases.profile_step import (bsgs_phase_cost,
                                                        bsgs_phase_cost_v1)
        phase_cost = {str(dt)[6:]: bsgs_phase_cost(dev, dt)
                      for dt in (torch.float32, torch.float64)}
        phase_cost_v1 = {str(dt)[6:]: bsgs_phase_cost_v1(dev, dt)
                         for dt in (torch.float32, torch.float64)}
        print("banded_bsgs phase cost", json.dumps(dict(
            phase_cost, v1=phase_cost_v1, card=CARD)), flush=True)
    paths = {}
    with phase("cylinder 640x320 solve (warm-up + timed)"):
        single_rep, paths["cylinder 640x320 banded"] = cylinder_path(dev)
    with phase("cylinder 640x320 gather bsgs x6 solve"):
        gather_rep, paths["cylinder 640x320 gather bsgs"] = gather_path(dev)
    with phase(f"cylinder 640x320 gather bcsgs x3: starter, {GATHER_STEPS} "
               "main steps"):
        paths["cylinder 640x320 gather bcsgs, main steps"] = bcsgs_steps(dev)
    with phase(f"cylinder 640x320: {COMPARE_STEPS} main steps, fused pc vs "
               "the sequence"):
        fused_vs_sequence(dev)
    check_mesh = f"cylinder {CHECK_MESH[0]}x{CHECK_MESH[1]}"
    with phase(f"{check_mesh} vs the JAX record"):
        cylinder_vs_record(dev)
    from fvens_tpu_torch.cases.bigmesh_case import GATHER_BCSGS, GATHER_BSGS
    for lin, blocked in ((GATHER_BSGS, True), (GATHER_BSGS, False),
                         (GATHER_BCSGS, False)):
        with phase(f"{check_mesh} gather {lin['pc']} "
                   f"{'blocked' if blocked else 'classic'} vs the JAX record"):
            cylinder_vs_record(dev, JAX_GATHER_RECORD, lin, blocked)
    with phase(f"bench {BENCH_STEPS}-step solve"):
        cm = bench_path(dev)
    with phase("bench first-order solve"):
        bench_first_order(dev, cm)
    with phase("bench twin steps"):
        bench_twins(dev, cm)
    with phase("small solves vs the JAX package"):
        small_solves(dev)
    with phase(f"cli {CLI_MESH[0]}x{CLI_MESH[1]}"):
        _, paths[f"cli {CLI_MESH[0]}x{CLI_MESH[1]}"] = cli_path(dev)
    with phase(f"cli {check_mesh[9:]} vs the JAX record"):
        cli_check = cli_vs_record(dev)
    with phase(f"A: scheme sweep at {SWEEP_MESH[0]}x{SWEEP_MESH[1]}"):
        scheme_sweep(dev)
    naca = f"naca cli {NACA_MESH[0]}x{NACA_MESH[1]}"
    with phase(f"B1: {naca}"):
        paths[naca] = naca_cli_path(dev)
    with phase(f"B1: naca cli {NACA_CHECK_MESH[0]}x{NACA_CHECK_MESH[1]}, "
               f"{NACA_CHECK_MAIN_STEPS} main steps, vs the JAX record"):
        naca_cli_vs_record(dev)
    limited = "cylinder 640x320 banded Venkatakrishnan, starter + " \
        f"{LIMITED_MAIN_STEPS} main steps"
    with phase(f"B2: {limited}"):
        paths[limited] = limited_banded_path(dev)
    explicit = f"explicit cli {EXPLICIT_MESH[0]}x{EXPLICIT_MESH[1]}"
    with phase(f"C: {explicit}"):
        paths[explicit] = explicit_cli_path(dev)
    vortex = f"vortex TVD-RK3 {VORTEX_N}x{VORTEX_N}"
    with phase(f"D: {vortex}"):
        paths[vortex] = vortex_path(dev)
    heat = f"heat {HEAT_N[-1]}x{HEAT_N[-1]}"
    with phase(f"E: {heat}, gather and banded"):
        paths[heat], paths[f"{heat} banded"] = heat_path(dev)
    options_phases(dev, paths, gather_rep)
    j1 = dist_phases(dev, paths, cli_check)
    precision_phases(dev, paths, single_rep)
    stepping = stepping_phases(dev, paths, single_rep)
    print("J1 beside I1", json.dumps(dict(
        j1_ms_per_main_step=j1["ms_per_main_step"],
        j1_ms_per_main_step_net_of_capture=j1[
            "ms_per_main_step_net_of_capture"],
        g1_host_loop_ms_per_main_step=j1["g1_host_loop_ms_per_main_step"],
        i1_ms_per_main_step=stepping["i1"]["ms_per_main_step"],
        i1_ms_per_main_step_net_of_capture=stepping["i1"][
            "ms_per_main_step_net_of_capture"], card=CARD)), flush=True)

    def main_row(rows, **want):
        return next(r for r in rows if r["dtype"] == "float32"
                    and r.get("path", "cyl").startswith("cyl")
                    and all(r[k] == v for k, v in want.items()))
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "device_ms")
    mv = main_row(brows, op="matvec")
    pc = main_row(frows)
    rs = main_row(rrows, n=ROWSET_SIZES[0])
    sb = next(r for r in srows if r["role"] == "bsgs"
              and r["dtype"] == "float64")
    gv = next(r for r in stepping["givens"]
              if r["dtype"] == "float32" and r["j"] == GIVENS_J[1])

    def v1_rows(rows, **want):
        """The heat equation's 1x1-block rows, f32 and f64."""
        return [{k: r.get(k) for k in (
            "op", "K", "dtype", "NC", "design", "max_abs_err", *keys,
            "bound_bytes", "bound_share", "library_ms",
            "sequence_device_ms", "equal_to_sequence", "cluster",
            "clusters", "slice", "smem_bytes")
            if k in r} for r in rows if r["V"] == 1
            and all(r[k] == v for k, v in want.items())]
    cooperative = {(r["NC"], r["dtype"]): r["device_ms"] for r in frows
                   if r["V"] == 1 and r["design"] == "cooperative"}
    hc = next(r for r in frows if r["V"] == 1 and r["design"] == "cluster"
              and r["dtype"] == "float64" and r["NC"] == HEAT_N[-1] ** 2)
    measured = {
        "banded_apply": dict(
            max_abs_err=max(r["max_abs_err"] for r in brows),
            library_ms=mv.get("library_ms"),
            **{k: mv[k] for k in keys},
            shape=f"f32 matvec, K=7, NC={mv['NC']}",
            library=("torch.sparse_bsr_tensor @ x" if mv.get("library_ms")
                     else mv.get("library_error")),
            v1=dict(rows=v1_rows(brows), library="torch.sparse_csr_tensor "
                    "@ x (the matvec)")),
        "banded_bsgs": dict(
            max_abs_err=max(r["max_abs_err"] for r in frows),
            library_ms=None, **{k: pc[k] for k in keys},
            sequence_ms=pc["sequence_ms"],
            sequence_device_ms=pc["sequence_device_ms"], n_res=pc["n_res"],
            bound_share=pc["bound_share"],
            fused_over_sequence=pc["fused_over_sequence"],
            phases=pc["phases"],
            other_applies=[{k: r[k] for k in (
                "path", "NC", "dtype", "design", "device_ms",
                "sequence_device_ms", "bound_ms", "bound_share",
                "fused_over_sequence")}
                for r in frows if r is not pc],
            phase_cost=phase_cost,
            v1=dict(rows=v1_rows(frows, design="cooperative")),
            shape=f"f32 bsgs apply, K={pc['K']}, {pc['sweeps']} sweeps, "
                  f"NC={pc['NC']}",
            library="no single PyTorch call computes the sweeps"),
        "banded_bsgs_cluster": dict(
            max_abs_err=max(r["max_abs_err"] for r in frows
                            if r["design"] == "cluster"),
            library_ms=None, **{k: hc[k] for k in keys},
            sequence_device_ms=hc["sequence_device_ms"],
            bound_share=hc["bound_share"],
            cooperative_device_ms=cooperative[hc["NC"], hc["dtype"]],
            plan={k: hc[k] for k in ("cluster", "clusters", "owned",
                                     "slice", "smem_bytes")},
            rows=v1_rows(frows, design="cluster"),
            phase_cost=phase_cost_v1,
            shape=f"f64 bsgs apply, 1x1 blocks, K={hc['K']}, "
                  f"{hc['sweeps']} sweeps, NC={hc['NC']} (the heat "
                  "equation's; its solve runs f64)",
            library="no single PyTorch call runs the sweeps"),
        "row_set": dict(
            max_abs_err=max(r["max_abs_err"] for r in rrows),
            library_ms=None, **{k: rs[k] for k in keys},
            shape=f"f32 row {rs['j']} of a (96, {rs['n']}) basis",
            library="no single PyTorch call: w / clamp_min(hn) is two"),
        "slot_gather": dict(
            max_abs_err=max(r["rel_err"] for r in srows),
            **{k: sb[k] for k in ("device_ms", "plain_ms", "bound_ms",
                                  "library_ms", "bound_share")},
            rows=srows,
            shape=f"f64 bsgs apply, {sb['sweeps']} sweeps, NC={sb['NC']} "
                  "(the NACA cell's); the f32 apply and both matvecs in "
                  "rows",
            library="index_select and torch.bmm (the formula it "
                    "replaced)"),
        "givens_column": dict(
            max_abs_err=max(r["max_abs_err"] for r in stepping["givens"]),
            library_ms=None,
            **{k: gv[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "device_ms")},
            rows=stepping["givens"],
            shape=f"f32, iteration j={gv['j']} of FGMRES({gv['m']})",
            note="latency-bound: one block, a dependent chain of j "
                 "rotations; the bound is its bytes at the memory rate",
            library="none: no PyTorch call applies Givens rotations"),
        "graph_if": dict(
            library_ms=None,
            **{k: stepping["graph_if"][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "live_node_ms", "set_kernel_dead_node_ms",
                "set_kernel_live_node_ms", "plain")},
            shape=f"an IF node its handle left dead (a dead Krylov "
                  f"iteration), per node of {IF_NODES}; live: with a "
                  f"one-kernel body",
            library="none in the card's torch (2.13's CUDAGraph."
                    "begin_capture_to_if_node is not there)"),
        "cond_set": dict(
            library_ms=None,
            **{k: stepping["cond_set"][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "device_ms", "cases", "torch_form_ms", "torch_form")},
            shape="f32 hn < 0.7 * wn0, written to a bool (a call of its "
                  "own)",
            library="none: the torch form is two calls and sets no "
                    "graph condition"),
    }
    # each kernel's launches from the path of its slice that runs it: the
    # banded kernels from the 640x320 banded solve (the cluster kernel from
    # the 512x512 banded heat solve), row_set from the 640x320 gather
    # solve, the Givens kernel and the IF nodes from the pipelined solve
    # (counted on the card: they run inside CUDA graphs)
    launches = dict(paths["cylinder 640x320 banded"],
                    banded_bsgs_cluster=paths[f"{heat} banded"][
                        "banded_bsgs_cluster"],
                    row_set=paths["cylinder 640x320 gather bsgs"]["row_set"],
                    slot_gather=paths["cylinder 640x320 gather bsgs"][
                        "slot_gather"],
                    givens_column=stepping["launches"]["givens_column"],
                    graph_if=stepping["launches"]["graph_if"],
                    cond_set=stepping["launches"]["cond_set"])
    print("phases", json.dumps(PHASES), flush=True)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=replaces,
             launches=launches[name], **measured[name],
             launches_by_path={p: n.get(name, 0)
                               for p, n in paths.items()})
        for name, (src, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
