/* Native greedy-traceback walker (the port's own copy of the affine walk
 * in deepblast_tpu/native/ctraceback.c).
 *
 * Mirrors deepblast_torch.ops.dp._traceback_walk exactly -- the same
 * -100000 sentinel, the same first-max-wins tie order (left, diag, up) as
 * np.argmax, the same trailing-gap padding -- over an affine cell layout
 *
 *   cell(i, j) = base[i*si + j*sj]
 *
 * which covers the natural (N, M) matrix (si=M, sj=1) and a pair's block
 * of the port's (B, K, S) expected-alignment stream, where cell (i, j)
 * sits at [b, i+j, i+1] (si=S+1, sj=S, base pre-offset by b*K*S + 1).
 *
 * The walk emits (i, j, state) int32 triples in alignment order into `out`
 * (capacity `cap` triples) and returns the triple count, or -1 on overflow
 * (callers size cap = n + m + 1, the worst case).
 *
 * Compiled at first use by deepblast_torch/native/__init__.py
 * (cc -O3 -shared -fPIC).
 */

#include <stdint.h>

#define NEG -100000.0

enum { ST_X = 0, ST_M = 1, ST_Y = 2 };

/* ------------------------------------------------------------------ */
/* shared walk over a cell accessor                                    */
/* ------------------------------------------------------------------ */

#define DEFINE_WALK(NAME, CTX, GET)                                        \
    static int64_t NAME(CTX ctx, int64_t n, int64_t m,                     \
                        int32_t *out, int64_t cap)                         \
    {                                                                      \
        int64_t i = n - 1, j = m - 1, k = cap;                             \
        /* fill from the back: emitting reversed gives alignment order */  \
        if (k < 1) return -1;                                              \
        out[--k * 3 + 2] = ST_M;                                           \
        out[k * 3 + 0] = (int32_t)i;                                       \
        out[k * 3 + 1] = (int32_t)j;                                       \
        for (;;) {                                                         \
            double left = (i <= 0) ? NEG : GET(ctx, i - 1, j);             \
            double diag = (i <= 0 || j <= 0) ? NEG : GET(ctx, i - 1, j - 1);\
            double up = (j <= 0) ? NEG : GET(ctx, i, j - 1);               \
            int s;                                                         \
            if (left == NEG && diag == NEG && up == NEG) break;            \
            /* np.argmax semantics: NaN is the max (first NaN wins),   */  \
            /* else first-max-wins — strict > to displace              */  \
            if (left != left) { i--; s = ST_X; }                           \
            else if (diag != diag) { i--; j--; s = ST_M; }                 \
            else if (up != up) { j--; s = ST_Y; }                          \
            else if (diag > left) {                                        \
                if (up > diag) { j--; s = ST_Y; }                          \
                else { i--; j--; s = ST_M; }                               \
            } else {                                                       \
                if (up > left) { j--; s = ST_Y; }                          \
                else { i--; s = ST_X; }                                    \
            }                                                              \
            if (k < 1) return -1;                                          \
            out[--k * 3 + 0] = (int32_t)i;                                 \
            out[k * 3 + 1] = (int32_t)j;                                   \
            out[k * 3 + 2] = (int32_t)s;                                   \
        }                                                                  \
        while (i > 0) {                                                    \
            if (k < 1) return -1;                                          \
            i--;                                                           \
            out[--k * 3 + 0] = (int32_t)i;                                 \
            out[k * 3 + 1] = (int32_t)j;                                   \
            out[k * 3 + 2] = ST_X;                                         \
        }                                                                  \
        while (j > 0) {                                                    \
            if (k < 1) return -1;                                          \
            j--;                                                           \
            out[--k * 3 + 0] = (int32_t)i;                                 \
            out[k * 3 + 1] = (int32_t)j;                                   \
            out[k * 3 + 2] = ST_Y;                                         \
        }                                                                  \
        /* slide the block to the front of out */                          \
        {                                                                  \
            int64_t cnt = cap - k, t;                                      \
            if (k > 0)                                                     \
                for (t = 0; t < cnt * 3; t++) out[t] = out[k * 3 + t];     \
            return cnt;                                                    \
        }                                                                  \
    }

/* ------------------------------------------------------------------ */
/* affine accessor (f32 / f64)                                         */
/* ------------------------------------------------------------------ */

typedef struct {
    const float *base;
    int64_t si, sj;
} aff32;

typedef struct {
    const double *base;
    int64_t si, sj;
} aff64;

#define GET_AFF(ctx, i, j) ((double)(ctx)->base[(i) * (ctx)->si + (j) * (ctx)->sj])

DEFINE_WALK(walk_aff32, const aff32 *, GET_AFF)
DEFINE_WALK(walk_aff64, const aff64 *, GET_AFF)

int64_t traceback_affine_f32(const float *base, int64_t si, int64_t sj,
                             int64_t n, int64_t m, int32_t *out, int64_t cap)
{
    aff32 ctx = {base, si, sj};
    return walk_aff32(&ctx, n, m, out, cap);
}

int64_t traceback_affine_f64(const double *base, int64_t si, int64_t sj,
                             int64_t n, int64_t m, int32_t *out, int64_t cap)
{
    aff64 ctx = {base, si, sj};
    return walk_aff64(&ctx, n, m, out, cap);
}
