/* C ABI of the dcora_tpu native runtime library.
 *
 * Native (C++) counterparts of the host-side data path: dataset loaders
 * (g2o / PyFG) and the block-Jacobi preconditioner assembly.  The compute
 * path (cost, gradients, solvers) is JAX/XLA on the device; this library covers
 * the parts the reference implements natively in C++ (its parsers in
 * DCORA_utils.cpp:179-1167 and graph assembly in Graph.cpp) where Python
 * object manipulation would otherwise dominate host time.
 *
 * Conventions: all matrices are row-major f64; all index arrays are int64.
 * Parse functions return NULL on failure and write a message into errbuf.
 */
#ifndef DCORA_NATIVE_H
#define DCORA_NATIVE_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ---------------- g2o loader (reference: DCORA_utils.cpp:179-375) -------- */

typedef struct DcoraG2o DcoraG2o;

DcoraG2o *dcora_g2o_parse(const char *path, char *errbuf, int errlen);
int dcora_g2o_dim(const DcoraG2o *h);
int64_t dcora_g2o_num_vertices(const DcoraG2o *h);
int64_t dcora_g2o_num_edges(const DcoraG2o *h);
/* ids: [nv]; Rs: [nv, d, d]; ts: [nv, d] */
void dcora_g2o_get_vertices(const DcoraG2o *h, int64_t *ids, double *Rs,
                            double *ts);
/* is, js: [ne]; Rs: [ne, d, d]; ts: [ne, d]; kappas, taus: [ne] */
void dcora_g2o_get_edges(const DcoraG2o *h, int64_t *is, int64_t *js,
                         double *Rs, double *ts, double *kappas,
                         double *taus);
void dcora_g2o_free(DcoraG2o *h);

/* ---------------- PyFG loader (reference: DCORA_utils.cpp:437-1167) ------ */

typedef struct DcoraPyfg DcoraPyfg;

enum DcoraPyfgKind {
  DCORA_PYFG_GT_POSE = 0,
  DCORA_PYFG_GT_LANDMARK = 1,
  DCORA_PYFG_POSE_PRIOR = 2,
  DCORA_PYFG_LANDMARK_PRIOR = 3,
  DCORA_PYFG_REL_POSE_POSE = 4,
  DCORA_PYFG_REL_POSE_LANDMARK = 5,
  DCORA_PYFG_RANGE = 6,
};

DcoraPyfg *dcora_pyfg_parse(const char *path, char *errbuf, int errlen);
int dcora_pyfg_dim(const DcoraPyfg *h);
int64_t dcora_pyfg_count(const DcoraPyfg *h, int kind);
void dcora_pyfg_get_gt_poses(const DcoraPyfg *h, int64_t *robots,
                             int64_t *states, double *Rs, double *ts);
void dcora_pyfg_get_gt_landmarks(const DcoraPyfg *h, int64_t *robots,
                                 int64_t *states, double *ts);
void dcora_pyfg_get_pose_priors(const DcoraPyfg *h, int64_t *robots,
                                int64_t *states, double *Rs, double *ts,
                                double *kappas, double *taus);
void dcora_pyfg_get_landmark_priors(const DcoraPyfg *h, int64_t *robots,
                                    int64_t *states, double *ts,
                                    double *taus);
/* seq: global file-order sequence over all relative measurements */
void dcora_pyfg_get_rel_pose_pose(const DcoraPyfg *h, int64_t *seq,
                                  int64_t *r1, int64_t *p1, int64_t *r2,
                                  int64_t *p2, double *Rs, double *ts,
                                  double *kappas, double *taus);
void dcora_pyfg_get_rel_pose_landmark(const DcoraPyfg *h, int64_t *seq,
                                      int64_t *r1, int64_t *p1, int64_t *r2,
                                      int64_t *p2, double *ts, double *taus);
/* st1/st2: 0 = pose, 1 = landmark; l: per-source-robot unit-sphere index;
 * gt_u: [m, d] ground-truth unit vector */
void dcora_pyfg_get_ranges(const DcoraPyfg *h, int64_t *seq, int64_t *r1,
                           int64_t *p1, int64_t *st1, int64_t *r2,
                           int64_t *p2, int64_t *st2, int64_t *l,
                           double *ranges, double *precisions, double *gt_u);
void dcora_pyfg_free(DcoraPyfg *h);

/* -------- block-Jacobi preconditioner assembly (Graph.cpp:1888-1960) -----
 *
 * Assembles the (d+1)x(d+1) per-pose diagonal blocks of Q in the
 * SE-interleaved basis plus scalar diagonals for unit spheres and
 * landmarks, adds `reg` to every diagonal, and inverts the pose blocks
 * (Cholesky).  Indices >= the local count are dropped (fixed-neighbor
 * slots).  Outputs: pose_inv [n, d+1, d+1], sph_diag [l], lmk_diag [b].
 * Returns 0 on success, nonzero if a pose block is not positive definite.
 */
int dcora_jacobi_precond(
    int64_t n, int64_t nsph, int64_t nlmk, int d, double reg,
    /* pose-pose edges */
    int64_t mpp, const int64_t *pp_ri, const int64_t *pp_rj,
    const double *pp_t, const double *pp_kappa, const double *pp_tau,
    const double *pp_w,
    /* pose-landmark edges */
    int64_t mpl, const int64_t *pl_ri, const int64_t *pl_tj,
    const double *pl_t, const double *pl_tau, const double *pl_w,
    /* range edges */
    int64_t mrg, const int64_t *rg_ti, const int64_t *rg_tj,
    const int64_t *rg_q, const double *rg_rho, const double *rg_prec,
    const double *rg_w,
    /* outputs */
    double *pose_inv, double *sph_diag, double *lmk_diag);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* DCORA_NATIVE_H */
