/* Single-threaded C baseline for block-simplex-constrained least squares.
 *
 * Mirrors the reference implementation's architecture (SURVEY.md §1a,
 * §3a): a Python-style driver loop around C kernels — CSR sparse matvec,
 * sort-based per-block simplex projection (arXiv:1101.6081), PAVA isotonic
 * regression, and projected gradient with an exact quadratic line search.
 * This binary produces the *measured* denominator for the >=10x
 * iterations/s target: no published reference numbers exist, so the C
 * baseline is benchmarked on the same host alongside the device build.
 *
 * Input: binary instance file (see io format below).  Output: one JSON line
 * with iterations/sec and the final objective.
 *
 * Build: make (gcc -O2 -march=native).
 */
#define _POSIX_C_SOURCE 199309L
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

/* ---------------- instance ----------------
 * file format (little endian):
 *   int64 m, n, nnz, B
 *   int64 indptr[m+1]
 *   int32 indices[nnz]
 *   double data[nnz]
 *   double b[m]
 *   int64 block_sizes[B]
 */
typedef struct {
    int64_t m, n, nnz, B;
    int64_t *indptr;
    int32_t *indices;
    double *data;
    double *b;
    int64_t *bs;
} instance;

static void die(const char *msg) {
    fprintf(stderr, "baseline_c: %s\n", msg);
    exit(1);
}

static void *xread(FILE *f, size_t sz, size_t n) {
    void *p = malloc(sz * n);
    if (!p || fread(p, sz, n, f) != n) die("short read");
    return p;
}

static instance load(const char *path) {
    FILE *f = fopen(path, "rb");
    if (!f) die("cannot open instance");
    instance in;
    int64_t hdr[4];
    if (fread(hdr, 8, 4, f) != 4) die("short header");
    in.m = hdr[0]; in.n = hdr[1]; in.nnz = hdr[2]; in.B = hdr[3];
    in.indptr = xread(f, 8, in.m + 1);
    in.indices = xread(f, 4, in.nnz);
    in.data = xread(f, 8, in.nnz);
    in.b = xread(f, 8, in.m);
    in.bs = xread(f, 8, in.B);
    fclose(f);
    return in;
}

/* ---------------- kernels ---------------- */

static void csr_matvec(const instance *in, const double *x, double *y) {
    for (int64_t i = 0; i < in->m; i++) {
        double acc = 0.0;
        for (int64_t k = in->indptr[i]; k < in->indptr[i + 1]; k++)
            acc += in->data[k] * x[in->indices[k]];
        y[i] = acc;
    }
}

static void csr_rmatvec(const instance *in, const double *r, double *g) {
    memset(g, 0, in->n * sizeof(double));
    for (int64_t i = 0; i < in->m; i++) {
        double ri = r[i];
        for (int64_t k = in->indptr[i]; k < in->indptr[i + 1]; k++)
            g[in->indices[k]] += in->data[k] * ri;
    }
}

static int cmp_desc(const void *a, const void *b) {
    double x = *(const double *)a, y = *(const double *)b;
    return (x < y) - (x > y);
}

/* Euclidean projection of v[0..n) onto the unit simplex; scratch u[0..n). */
static void proj_simplex(double *v, int64_t n, double *u) {
    if (n == 1) { v[0] = 1.0; return; }
    memcpy(u, v, n * sizeof(double));
    qsort(u, n, sizeof(double), cmp_desc);
    double css = 0.0, tau = 0.0;
    int64_t rho = -1;
    for (int64_t k = 0; k < n; k++) {
        css += u[k];
        double t = (css - 1.0) / (double)(k + 1);
        if (u[k] - t > 0.0) { rho = k; tau = t; }
    }
    (void)rho;
    for (int64_t j = 0; j < n; j++) {
        double x = v[j] - tau;
        v[j] = x > 0.0 ? x : 0.0;
    }
}

static void proj_multi_simplex(double *x, const int64_t *bs, int64_t B, double *scratch) {
    int64_t off = 0;
    for (int64_t b = 0; b < B; b++) {
        proj_simplex(x + off, bs[b], scratch);
        off += bs[b];
    }
}

/* Bounded nondecreasing PAVA (stack-based, O(n)); exported for parity with
 * the reference's isotonic_regression_c — exercised via --pava. */
static void pava(const double *y, double *out, int64_t n, double lo, double hi) {
    double *mean = malloc(n * sizeof(double));
    double *wt = malloc(n * sizeof(double));
    int64_t *len = malloc(n * sizeof(int64_t));
    int64_t top = 0;
    for (int64_t i = 0; i < n; i++) {
        double m = y[i], w = 1.0;
        int64_t l = 1;
        while (top > 0 && mean[top - 1] > m) {
            m = (m * w + mean[top - 1] * wt[top - 1]) / (w + wt[top - 1]);
            w += wt[top - 1];
            l += len[top - 1];
            top--;
        }
        mean[top] = m; wt[top] = w; len[top] = l; top++;
    }
    int64_t off = 0;
    for (int64_t s = 0; s < top; s++)
        for (int64_t j = 0; j < len[s]; j++) {
            double v = mean[s];
            if (v < lo) v = lo;
            if (v > hi) v = hi;
            out[off++] = v;
        }
    free(mean); free(wt); free(len);
}

static double dot(const double *a, const double *b, int64_t n) {
    double s = 0.0;
    for (int64_t i = 0; i < n; i++) s += a[i] * b[i];
    return s;
}

/* ---------------- solver ---------------- */

int main(int argc, char **argv) {
    if (argc < 3)
        die("usage: bsls_baseline <instance.bin> <iters> "
            "[--pava] [--ls bb|exact] [--fstar F] [--rel R]");
    instance in = load(argv[1]);
    int iters = atoi(argv[2]);
    int use_pava_smoke = 0, use_bb = 0;
    double fstar = 0.0, rel = 0.0;
    int have_fstar = 0;
    for (int a = 3; a < argc; a++) {
        if (!strcmp(argv[a], "--pava")) use_pava_smoke = 1;
        else if (!strcmp(argv[a], "--ls") && a + 1 < argc)
            use_bb = !strcmp(argv[++a], "bb");
        else if (!strcmp(argv[a], "--fstar") && a + 1 < argc) {
            fstar = atof(argv[++a]); have_fstar = 1;
        } else if (!strcmp(argv[a], "--rel") && a + 1 < argc)
            rel = atof(argv[++a]);
    }
    double fmax = fabs(fstar) > 1.0 ? fabs(fstar) : 1.0;
    double thresh = fstar + (rel > 0 ? rel : 1e-6) * fmax;

    double *x = malloc(in.n * sizeof(double));
    double *g = malloc(in.n * sizeof(double));
    double *d = malloc(in.n * sizeof(double));
    double *r = malloc(in.m * sizeof(double));
    double *Ad = malloc(in.m * sizeof(double));
    double *x_prev = malloc(in.n * sizeof(double));
    double *g_prev = malloc(in.n * sizeof(double));
    int64_t wmax = 0;
    for (int64_t b0 = 0; b0 < in.B; b0++) if (in.bs[b0] > wmax) wmax = in.bs[b0];
    double *scratch = malloc((size_t)wmax * sizeof(double));

    /* uniform feasible start */
    {
        int64_t off = 0;
        for (int64_t b0 = 0; b0 < in.B; b0++) {
            for (int64_t j = 0; j < in.bs[b0]; j++) x[off + j] = 1.0 / (double)in.bs[b0];
            off += in.bs[b0];
        }
    }

    if (use_pava_smoke) { /* exercise the PAVA kernel once for parity checks */
        pava(x, g, in.n < 64 ? in.n : 64, 0.0, 1.0);
    }

    /* Lipschitz estimate by power iteration */
    double L = 1.0;
    {
        double *v = malloc(in.n * sizeof(double));
        for (int64_t i = 0; i < in.n; i++) v[i] = 1.0 + (double)(i % 7);
        for (int it = 0; it < 30; it++) {
            csr_matvec(&in, v, r);
            csr_rmatvec(&in, r, g);
            L = sqrt(dot(g, g, in.n));
            if (L <= 0) { L = 1.0; break; }
            for (int64_t i = 0; i < in.n; i++) v[i] = g[i] / L;
        }
        L *= 1.05;
        free(v);
    }

    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    double f = 0.0, hit_secs = -1.0;
    int it, hit_iter = -1;
    for (it = 0; it < iters; it++) {
        /* gradient */
        csr_matvec(&in, x, r);
        for (int64_t i = 0; i < in.m; i++) r[i] -= in.b[i];
        f = 0.5 * dot(r, r, in.m);
        csr_rmatvec(&in, r, g);
        if (have_fstar && f <= thresh) {
            clock_gettime(CLOCK_MONOTONIC, &t1);
            hit_iter = it;
            hit_secs = (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
            break;
        }
        double tstep = 1.0 / L;
        if (use_bb && it > 0) {
            /* Barzilai-Borwein step from the last iterate/gradient pair */
            double ss = 0.0, sy = 0.0;
            for (int64_t i = 0; i < in.n; i++) {
                double dx = x[i] - x_prev[i], dg = g[i] - g_prev[i];
                ss += dx * dx; sy += dx * dg;
            }
            if (sy > 1e-30) tstep = ss / sy;
        }
        if (use_bb) {
            memcpy(x_prev, x, in.n * sizeof(double));
            memcpy(g_prev, g, in.n * sizeof(double));
            /* non-monotone projected BB: x = proj(x - t_bb g) */
            for (int64_t i = 0; i < in.n; i++) x[i] -= tstep * g[i];
            proj_multi_simplex(x, in.bs, in.B, scratch);
            continue;
        }
        /* candidate: proj(x - g/L); direction d = cand - x */
        for (int64_t i = 0; i < in.n; i++) d[i] = x[i] - g[i] / L;
        proj_multi_simplex(d, in.bs, in.B, scratch);
        for (int64_t i = 0; i < in.n; i++) d[i] -= x[i];
        /* exact quadratic line search along d, clipped to [0,1] */
        csr_matvec(&in, d, Ad);
        double gd = dot(g, d, in.n);
        double dAAd = dot(Ad, Ad, in.m);
        double t = dAAd > 0 ? -gd / dAAd : 1.0;
        if (t < 0) t = 0;
        if (t > 1) t = 1;
        for (int64_t i = 0; i < in.n; i++) x[i] += t * d[i];
    }
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double secs = (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);

    csr_matvec(&in, x, r);
    for (int64_t i = 0; i < in.m; i++) r[i] -= in.b[i];
    f = 0.5 * dot(r, r, in.m);

    printf("{\"iters\": %d, \"secs\": %.6f, \"iters_per_sec\": %.3f, "
           "\"objective\": %.10e, \"ls\": \"%s\", "
           "\"iters_to_target\": %d, \"secs_to_target\": %.6f}\n",
           it, secs, it > 0 ? it / secs : 0.0, f, use_bb ? "bb" : "exact",
           hit_iter, hit_secs);
    return 0;
}
