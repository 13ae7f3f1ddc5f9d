// geomlib: native host-side point-cloud geometry kernels (the port's copy of
// open3dsot_tpu/native/geomlib.cpp; the code is the same line for line, so
// that both libraries, built on one machine with the same flags, give the
// same bits).
//
// The reference's host data path (datasets/points_utils.py) does repeated
// numpy passes over 100k-point clouds per sample: translate, rotate, AABB
// mask, compact. These fused single-pass kernels are the native equivalent
// of that layer, exposed through ctypes (open3dsot_tpu_torch/native/__init__.py)
// and used by the samplers / eval input builders; numpy remains the
// semantic reference, and the path taken with OPEN3DSOT_TPU_NATIVE=0.
//
// All comparisons are strict (<, >) in double precision to match the numpy
// reference exactly (points_utils.py:155-166).

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// Fused canonicalize + AABB crop.
//   points: (n, 3) float32, row-major (x, y, z)
//   rot:    (9,) double, row-major 3x3 world->local rotation (R^T of box)
//   trans:  (3,) double, box center (subtracted before rotation)
//   half:   (3,) double, crop half-extents in the local frame (+offset baked in)
//   out:    (n, 3) float32 buffer for the kept canonicalized points
// Returns the number of kept points.
int64_t crop_canonical(const float* points, int64_t n,
                       const double* rot, const double* trans,
                       const double* half, float* out) {
    int64_t kept = 0;
    const double r00 = rot[0], r01 = rot[1], r02 = rot[2];
    const double r10 = rot[3], r11 = rot[4], r12 = rot[5];
    const double r20 = rot[6], r21 = rot[7], r22 = rot[8];
    const double tx = trans[0], ty = trans[1], tz = trans[2];
    const double hx = half[0], hy = half[1], hz = half[2];
    for (int64_t i = 0; i < n; ++i) {
        const double px = (double)points[3 * i] - tx;
        const double py = (double)points[3 * i + 1] - ty;
        const double pz = (double)points[3 * i + 2] - tz;
        const double lx = r00 * px + r01 * py + r02 * pz;
        const double ly = r10 * px + r11 * py + r12 * pz;
        const double lz = r20 * px + r21 * py + r22 * pz;
        if (lx < hx && lx > -hx && ly < hy && ly > -hy && lz < hz && lz > -hz) {
            out[3 * kept] = (float)lx;
            out[3 * kept + 1] = (float)ly;
            out[3 * kept + 2] = (float)lz;
            ++kept;
        }
    }
    return kept;
}

// Plain AABB mask (world frame, strict bounds): writes 0/1 bytes.
int64_t aabb_mask(const float* points, int64_t n,
                  const double* mini, const double* maxi, uint8_t* mask) {
    int64_t kept = 0;
    for (int64_t i = 0; i < n; ++i) {
        const double x = points[3 * i], y = points[3 * i + 1], z = points[3 * i + 2];
        const uint8_t in =
            (x < maxi[0] && x > mini[0] && y < maxi[1] && y > mini[1] &&
             z < maxi[2] && z > mini[2])
                ? 1
                : 0;
        mask[i] = in;
        kept += in;
    }
    return kept;
}

// Inclusive oriented in-box test (nuScenes points_in_box semantics):
// local = R^T (p - c); inside iff |local| <= half.
void points_in_box(const float* points, int64_t n,
                   const double* rot, const double* center,
                   const double* half, uint8_t* mask) {
    const double r00 = rot[0], r01 = rot[1], r02 = rot[2];
    const double r10 = rot[3], r11 = rot[4], r12 = rot[5];
    const double r20 = rot[6], r21 = rot[7], r22 = rot[8];
    for (int64_t i = 0; i < n; ++i) {
        const double px = (double)points[3 * i] - center[0];
        const double py = (double)points[3 * i + 1] - center[1];
        const double pz = (double)points[3 * i + 2] - center[2];
        const double lx = r00 * px + r01 * py + r02 * pz;
        const double ly = r10 * px + r11 * py + r12 * pz;
        const double lz = r20 * px + r21 * py + r22 * pz;
        if (std::fabs(lx) <= half[0] && std::fabs(ly) <= half[1] &&
            std::fabs(lz) <= half[2]) {
            mask[i] = 1;
        } else {
            mask[i] = 0;
        }
    }
}

// BoxCloud: distances of (n, 3) points to 9 keypoints -> (n, 9) float32.
void box_cloud(const float* points, int64_t n, const double* keypoints9x3,
               float* out) {
    for (int64_t i = 0; i < n; ++i) {
        const double px = points[3 * i], py = points[3 * i + 1], pz = points[3 * i + 2];
        for (int k = 0; k < 9; ++k) {
            const double dx = px - keypoints9x3[3 * k];
            const double dy = py - keypoints9x3[3 * k + 1];
            const double dz = pz - keypoints9x3[3 * k + 2];
            out[9 * i + k] = (float)std::sqrt(dx * dx + dy * dy + dz * dz);
        }
    }
}

// Per-sample int16 fixed-point quantization of padded point batches — the
// native twin of utils/quant.py::quantize_per_sample (same semantics,
// bit-exact: f32 arithmetic, round-half-to-even, per-sample midrange
// offset + symmetric scale over the VALID rows). numpy needs ~8 passes
// over the batch; this is two (min/max, then encode), which matters
// because the eval pipeline's host side is the critical path on small
// hosts (see BENCH_E2E_EVAL.md).
//   pts: (b, m, 3) f32, valid: (b, m) uint8 -> q (b, m, 3) int16,
//   scale (b,) f32, off (b, 3) f32.
void quantize_per_sample(const float* pts, const uint8_t* valid,
                         int64_t b, int64_t m,
                         int16_t* q, float* scale, float* off) {
    for (int64_t s = 0; s < b; ++s) {
        const float* p = pts + s * m * 3;
        const uint8_t* v = valid + s * m;
        float lo[3], hi[3];
        int64_t nvalid = 0;
        for (int64_t i = 0; i < m; ++i) {
            if (!v[i]) continue;
            if (nvalid == 0) {
                lo[0] = hi[0] = p[3 * i];
                lo[1] = hi[1] = p[3 * i + 1];
                lo[2] = hi[2] = p[3 * i + 2];
            } else {
                for (int c = 0; c < 3; ++c) {
                    const float x = p[3 * i + c];
                    if (x < lo[c]) lo[c] = x;
                    if (x > hi[c]) hi[c] = x;
                }
            }
            ++nvalid;
        }
        if (nvalid == 0) {
            lo[0] = lo[1] = lo[2] = hi[0] = hi[1] = hi[2] = 0.0f;
        }
        float sc = 0.0f;
        for (int c = 0; c < 3; ++c) {
            off[3 * s + c] = (lo[c] + hi[c]) * 0.5f;
            const float d = std::fabs(hi[c] - off[3 * s + c]);
            if (d > sc) sc = d;
        }
        sc = sc / 32766.0f;
        if (!(sc > 1e-6f)) sc = 1e-6f;
        scale[s] = sc;
        // per-element f32 divide (not reciprocal-multiply): a reciprocal
        // differs in the last ulp from numpy's divide, and the contract is
        // bit-exactness with the numpy encoder
        const float ox = off[3 * s], oy = off[3 * s + 1], oz = off[3 * s + 2];
        int16_t* qo = q + s * m * 3;
        for (int64_t i = 0; i < m; ++i) {
            const float r0 = std::rint((p[3 * i] - ox) / sc);
            const float r1 = std::rint((p[3 * i + 1] - oy) / sc);
            const float r2 = std::rint((p[3 * i + 2] - oz) / sc);
            qo[3 * i] = (int16_t)(r0 < -32768.f ? -32768.f
                                                : (r0 > 32767.f ? 32767.f : r0));
            qo[3 * i + 1] = (int16_t)(r1 < -32768.f ? -32768.f
                                                    : (r1 > 32767.f ? 32767.f : r1));
            qo[3 * i + 2] = (int16_t)(r2 < -32768.f ? -32768.f
                                                    : (r2 > 32767.f ? 32767.f : r2));
        }
    }
}

// Gather rows: out[i] = points[idx[i]] for (n_out) int64 indices over (n, c).
void gather_rows(const float* points, int64_t n, int64_t c,
                 const int64_t* idx, int64_t n_out, float* out) {
    for (int64_t i = 0; i < n_out; ++i) {
        std::memcpy(out + c * i, points + c * idx[i], sizeof(float) * (size_t)c);
    }
}

}  // extern "C"
