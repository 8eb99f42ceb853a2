// Host-side audio/data ops of the SynTalker data pipeline (C++).
//
// The device path is PyTorch with hand-written CUDA kernels; these C++
// functions cover the host-side featurization hot spots that feed it:
//
//  - rolling_max_abs_f32: amplitude envelope. numpy's sliding_window_view
//    does O(n*w) work and materializes an n x 1024 view; this is the O(n)
//    monotonic-deque algorithm.
//  - peak_pick_f32: librosa-style onset peak picking without the Python
//    inner loop; window means from double-precision prefix sums.
//
// Built as a plain shared library with g++ and bound with ctypes in
// syntalker_tpu_torch/native/__init__.py; a failed build raises there.

#include <algorithm>
#include <cstdint>
#include <deque>
#include <vector>

extern "C" {

// Rolling max of |x| over `window` samples, stride 1, end-padded with the
// final value. out must have n elements.
void rolling_max_abs_f32(const float* x, int64_t n, int64_t window, float* out) {
    if (n <= 0) return;
    if (window > n) window = n;
    std::deque<int64_t> dq;  // indices of decreasing |x|
    auto absv = [&](int64_t i) { return x[i] < 0 ? -x[i] : x[i]; };
    const int64_t m = n - window + 1;  // number of full windows
    for (int64_t i = 0; i < n; ++i) {
        while (!dq.empty() && absv(dq.back()) <= absv(i)) dq.pop_back();
        dq.push_back(i);
        const int64_t start = i - window + 1;
        if (start >= 0) {
            while (dq.front() < start) dq.pop_front();
            out[start] = absv(dq.front());
        }
    }
    // pad the tail with the last full-window value
    const float last = m > 0 ? out[m - 1] : absv(dq.front());
    for (int64_t i = m; i < n; ++i) out[i] = last;
}

// librosa peak_pick: local max over [i-pre_max, i+post_max], above the
// moving mean over [i-pre_avg, i+post_avg] + delta, with a refractory
// `wait`. Returns the number of peaks written to out_idx (capacity n).
int64_t peak_pick_f32(const float* env, int64_t n, int64_t pre_max,
                      int64_t post_max, int64_t pre_avg, int64_t post_avg,
                      float delta, int64_t wait, int64_t* out_idx) {
    // prefix sums for O(1) window means
    std::vector<double> pre(n + 1, 0.0);
    for (int64_t i = 0; i < n; ++i) pre[i + 1] = pre[i] + env[i];

    int64_t count = 0;
    int64_t last = -1 - wait;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t lo_m = std::max<int64_t>(0, i - pre_max);
        const int64_t hi_m = std::min<int64_t>(n, i + post_max + 1);
        float wmax = env[lo_m];
        for (int64_t j = lo_m + 1; j < hi_m; ++j) wmax = std::max(wmax, env[j]);
        if (env[i] < wmax) continue;
        const int64_t lo_a = std::max<int64_t>(0, i - pre_avg);
        const int64_t hi_a = std::min<int64_t>(n, i + post_avg + 1);
        const double mean = (pre[hi_a] - pre[lo_a]) / double(hi_a - lo_a);
        if (env[i] < mean + delta) continue;
        if (i - last <= wait) continue;
        out_idx[count++] = i;
        last = i;
    }
    return count;
}

}  // extern "C"
