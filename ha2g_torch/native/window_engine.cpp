// Native windowing engine for the host data pipeline.
//
// Implements the compute-heavy inner loop of the dataset windowing stage
// (the reference runs this in Python/numpy per sample inside DataLoader
// workers, data_preprocessor.py:69-167 + motion_preprocessor.py):
//   1. linear resampling of the skeleton stream to the target fps
//   2. sliding extended windows with subdivision stride
//   3. the motion quality filter (near-mean pose, spine angle, static wrists)
//   4. pose -> unit direction vectors minus the dataset mean
//
// Exposed through a C ABI consumed via ctypes (ha2g_torch/native/__init__.py);
// the numpy implementation in ha2g_torch/data/dataset.py remains the
// reference semantics and the fallback — equivalence is enforced by
// tests/test_torch_native.py.  The code is the JAX package's engine
// (ha2g_tpu/native/window_engine.cpp) line for line: the two give the same
// bits with the same compiler and flags.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline float clampf(float v, float lo, float hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Linear resample of (n_in, dim) rows to the reference's sample grid:
// x_new = arange(0, n_in, n_in / (duration * fps))  (data_utils.py:46-56)
void resample(const float* in, int64_t n_in, int64_t dim, double duration,
              int fps, std::vector<float>& out, int64_t& n_out) {
    const double expected = duration * fps;
    const double step = static_cast<double>(n_in) / expected;
    n_out = static_cast<int64_t>(std::ceil(static_cast<double>(n_in) / step));
    out.resize(n_out * dim);
    for (int64_t i = 0; i < n_out; ++i) {
        const double x = i * step;
        int64_t i0 = static_cast<int64_t>(std::floor(x));
        if (i0 > n_in - 1) i0 = n_in - 1;
        int64_t i1 = i0 + 1 > n_in - 1 ? n_in - 1 : i0 + 1;
        const float frac = static_cast<float>(x - std::floor(x));
        const float* a = in + i0 * dim;
        const float* b = in + i1 * dim;
        float* o = out.data() + i * dim;
        for (int64_t d = 0; d < dim; ++d)
            o[d] = a[d] * (1.0f - frac) + b[d] * frac;
    }
}

// Motion quality filter (motion_preprocessor.py:32-86).  skel: window of
// (n_frames, n_joints, 3).  Returns 0 = PASS, 1 = pose, 2 = spine, 3 = static.
int motion_filter(const float* skel, int64_t n_frames, int64_t n_joints,
                  const float* mean_pose, int sj0, int sj1) {
    // near-mean pose
    double diff = 0.0;
    for (int64_t f = 0; f < n_frames; ++f)
        for (int64_t j = 0; j < n_joints * 3; ++j)
            diff += std::fabs(skel[f * n_joints * 3 + j] - mean_pose[j]);
    if (diff / (n_frames * n_joints * 3) < 0.02) return 1;

    // spine angle vs (0,-1,0): max > 30 deg or mean > 20 deg
    double max_angle = 0.0, sum_angle = 0.0;
    for (int64_t f = 0; f < n_frames; ++f) {
        const float* p0 = skel + (f * n_joints + 0) * 3;
        const float* p1 = skel + (f * n_joints + 1) * 3;
        float vx = p1[0] - p0[0], vy = p1[1] - p0[1], vz = p1[2] - p0[2];
        float norm = std::sqrt(vx * vx + vy * vy + vz * vz);
        float c = norm > 0 ? clampf(-vy / norm, -1.0f, 1.0f) : 1.0f;
        double ang = std::acos(c);
        sum_angle += ang;
        if (ang > max_angle) max_angle = ang;
    }
    const double deg = 180.0 / M_PI;
    if (max_angle * deg > 30.0 || (sum_angle / n_frames) * deg > 20.0)
        return 2;

    // static wrists: sum of per-axis variances below threshold for both
    double var[2] = {0.0, 0.0};
    const int joints[2] = {sj0, sj1};
    for (int k = 0; k < 2; ++k) {
        for (int d = 0; d < 3; ++d) {
            double mean = 0.0;
            for (int64_t f = 0; f < n_frames; ++f)
                mean += skel[(f * n_joints + joints[k]) * 3 + d];
            mean /= n_frames;
            double acc = 0.0;
            for (int64_t f = 0; f < n_frames; ++f) {
                double v = skel[(f * n_joints + joints[k]) * 3 + d] - mean;
                acc += v * v;
            }
            var[k] += acc / n_frames;
        }
    }
    if (var[0] < 0.0014 && var[1] < 0.0014) return 3;
    return 0;
}

}  // namespace

extern "C" {

// Returns the number of accepted windows (<= max_windows), or -1 on error.
// out_targets: (max_windows, n_poses, n_bones*3) mean-subtracted dir vecs
// out_poses:   (max_windows, n_poses, n_joints*3) resampled positions
// out_starts:  (max_windows,) window start frame in the resampled stream
int64_t window_clip(
    const float* skel, int64_t n_frames_in, int64_t n_joints,
    double duration, int fps,
    const int32_t* parents, const int32_t* children, int64_t n_bones,
    const float* mean_dir_vec, const float* mean_pose,
    int64_t n_poses, int64_t n_ext, int64_t stride,
    int32_t sj0, int32_t sj1, int32_t disable_filtering,
    float* out_targets, float* out_poses, int64_t* out_starts,
    int64_t max_windows) {
    if (n_frames_in < 2) return 0;
    std::vector<float> rs;
    int64_t n_frames = 0;
    resample(skel, n_frames_in, n_joints * 3, duration, fps, rs, n_frames);

    const int64_t num_sub = (n_frames - n_ext) / stride + 1;
    int64_t n_out = 0;
    for (int64_t w = 0; w < num_sub && n_out < max_windows; ++w) {
        const int64_t start = w * stride;
        const float* win = rs.data() + start * n_joints * 3;
        if (!disable_filtering &&
            motion_filter(win, n_ext, n_joints, mean_pose, sj0, sj1) != 0)
            continue;

        // clip to n_poses frames; emit positions + dir-vec targets
        float* tgt = out_targets + n_out * n_poses * n_bones * 3;
        float* pos = out_poses + n_out * n_poses * n_joints * 3;
        std::memcpy(pos, win, sizeof(float) * n_poses * n_joints * 3);
        for (int64_t f = 0; f < n_poses; ++f) {
            const float* frame = win + f * n_joints * 3;
            for (int64_t b = 0; b < n_bones; ++b) {
                const float* pp = frame + parents[b] * 3;
                const float* pc = frame + children[b] * 3;
                float dx = pc[0] - pp[0], dy = pc[1] - pp[1],
                      dz = pc[2] - pp[2];
                float norm = std::sqrt(dx * dx + dy * dy + dz * dz);
                float inv = norm > 1e-12f ? 1.0f / norm : 0.0f;
                float* o = tgt + (f * n_bones + b) * 3;
                o[0] = dx * inv - mean_dir_vec[b * 3 + 0];
                o[1] = dy * inv - mean_dir_vec[b * 3 + 1];
                o[2] = dz * inv - mean_dir_vec[b * 3 + 2];
            }
        }
        out_starts[n_out] = start;
        ++n_out;
    }
    return n_out;
}

}  // extern "C"
