"""g2o100k: single-chip feasibility + certification wall-clock breakdown.

BASELINE.json's north-star problem is a g2o100k-class pose graph (10x the
reference's largest bundled benchmark, city10000).  This runs the full
centralized pipeline on the synthetic 97,336-pose grid at that scale —
chordal init, mixed-precision staircase (f32 tiles -> f64 tiles -> exact
edge finish), certification, rounding — and records a wall-clock breakdown
of every certification component at k = 4n ~ 389k:

  * dual certificate blocks Lambda(X) on device
  * S = Q - Lambda(X) host assembly (scipy CSR)
  * LDL^T factorization PSD proof (the CHOLMOD-equivalent quick-return,
    reference isSparseSymmetricMatrixPSD, DCORA_utils.cpp:1737-1747)
  * the fail-closed host min-eig path (_min_eig_host: LDL -> ARPACK ->
    LOBPCG)
  * the independent scipy re-verification (verification.verify_solution)

Writes artifacts/g2o100k_certify.json.

Usage:
  python tools/g2o100k_certify.py [--cpu] [--rmax 8] [--tcg 50]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

ART = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")
CACHE = os.path.join(os.path.dirname(__file__), os.pardir, ".data_cache")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rmin", type=int, default=5)
    ap.add_argument("--rmax", type=int, default=8)
    ap.add_argument("--tcg", type=int, default=50,
                    help="tCG budget per outer (the reference's RBCD "
                    "default, ROptParameters DCORA_types.h:166-168)")
    ap.add_argument("--eta", type=float, default=1e-3)
    args = ap.parse_args()

    import logging

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import dcora_tpu  # noqa: F401
    from dcora_tpu.core import lifted, problem as prob
    from dcora_tpu.core.certify import (
        _assemble_S_host,
        _min_eig_host,
        dual_certificate_blocks,
        ldl_psd_proof,
    )
    from dcora_tpu.core.graph import LocalGraph
    from dcora_tpu.core.init import chordal_initialization
    from dcora_tpu.datasets import generate_large_scale_g2o
    from dcora_tpu.io import read_g2o_file
    from dcora_tpu.staircase import riemannian_staircase
    from dcora_tpu.types import ROptParameters

    path = os.path.join(CACHE, "g2o100k.g2o")
    if not os.path.exists(path):
        os.makedirs(CACHE, exist_ok=True)
        print("generating g2o100k ...", flush=True)
        generate_large_scale_g2o(path)

    rec = {"dataset": "g2o100k", "platform": jax.default_backend()}
    t0 = time.time()
    ds = read_g2o_file(path)
    rec["t_parse_s"] = time.time() - t0
    d, n = ds.dim, ds.num_poses
    ms = ds.pose_pose_measurements
    rec["n_poses"] = n
    rec["n_edges"] = len(ms)
    print(f"g2o100k: n={n} edges={len(ms)}", flush=True)

    g = LocalGraph(0, args.rmin, d)
    g.set_measurements(ms)

    t0 = time.time()
    T0 = chordal_initialization(ms)
    rec["t_chordal_init_s"] = time.time() - t0
    print(f"chordal init: {rec['t_chordal_init_s']:.1f}s", flush=True)

    X0 = lifted.pad_rank(lifted.from_pose_array(T0), args.rmin)
    t0 = time.time()
    # the multi-hour staircase survives preemption: resume = re-run
    ckpt = os.path.join(CACHE, "ckpt_g2o100k.npz")
    res = riemannian_staircase(
        g, X0, r_min=args.rmin, r_max=args.rmax,
        opt_params=ROptParameters(
            gradnorm_tol=1e-4, RTR_iterations=200,
            RTR_tCG_iterations=args.tcg,
        ),
        min_eig_num_tol=args.eta, verbose=True,
        checkpoint_path=ckpt,
    )
    rec["t_solve_s"] = time.time() - t0
    np.savez_compressed(
        os.path.join(ART, "parity", "state", "g2o100k.npz"),
        rot=np.asarray(res.X.rot), sph=np.asarray(res.X.sph),
        trn=np.asarray(res.X.trn),
    )
    rec["certified"] = bool(res.certified)
    rec["final_rank"] = int(res.final_rank)
    rec["f_final"] = float(res.f_final)
    P = g.problem_data()
    rec["f_rounded"] = float(prob.cost(P, res.rounded))
    print(f"solve: certified={res.certified} rank={res.final_rank} "
          f"f={res.f_final:.6f} in {rec['t_solve_s']:.1f}s", flush=True)

    # ---- certification wall-clock breakdown at the final X ----
    dims = res.X.dims
    k = dims.k
    rec["k"] = int(k)
    t0 = time.time()
    C = jax.block_until_ready(dual_certificate_blocks(P, res.X))
    rec["t_lambda_device_s"] = time.time() - t0
    t0 = time.time()
    S = _assemble_S_host(P, C, dims)
    rec["t_S_assemble_s"] = time.time() - t0
    rec["S_nnz"] = int(S.nnz)
    import scipy.sparse as sp

    t0 = time.time()
    proof = ldl_psd_proof(S + args.eta * sp.identity(k, format="csr"))
    rec["t_ldl_proof_s"] = time.time() - t0
    rec["ldl_proof"] = proof
    print(f"LDL^T PSD proof: {proof} in {rec['t_ldl_proof_s']:.1f}s "
          f"(k={k}, nnz={S.nnz})", flush=True)
    t0 = time.time()
    cert_host, lam_host, _ = _min_eig_host(P, C, dims, args.eta)
    rec["t_min_eig_host_s"] = time.time() - t0
    rec["min_eig_host_certified"] = bool(cert_host)
    rec["min_eig_host_theta"] = float(lam_host)
    print(f"host min-eig path: certified={cert_host} theta={lam_host:.3e} "
          f"in {rec['t_min_eig_host_s']:.1f}s", flush=True)

    # ---- independent scipy re-verification (shares no engine code) ----
    from dcora_tpu import verification as V

    t0 = time.time()
    rep = V.verify_solution(ms, res.X, d, eta=args.eta)
    rec["t_verify_indep_s"] = time.time() - t0
    rec.update(rep)
    rec["timestamp"] = time.strftime("%Y-%m-%d %H:%M:%S")

    os.makedirs(ART, exist_ok=True)
    out = os.path.join(ART, "g2o100k_certify.json")
    with open(out, "w") as fh:
        json.dump(rec, fh, indent=1, default=str)
    print(json.dumps(rec, indent=1, default=str), flush=True)


if __name__ == "__main__":
    main()
