// 1D segment NMS on the host (the eval's reference_exact mode; a copy of
// decafnet_tpu/ops/native/nms1d.cpp).
//
// Standalone C ABI (no torch/pybind dependency), built with g++ and loaded
// via ctypes by decafnet_tpu_torch/ops/nms.py. Semantics match the reference
// torch extension (reference: libs/nms/src/nms_cpu.cpp:20-181):
//   * nms1d:    greedy hard NMS -- sort by score descending, suppress any
//               later segment whose IoU with a kept one is >= iou_thresh.
//   * softnms1d: selection-sort soft NMS -- repeatedly pick the max-score
//               segment, emit (x1, x2, score) into `dets`, decay remaining
//               scores by the gaussian exp(-iou^2 / sigma) (the reference's
//               method 2, the one the configs use), and drop segments
//               falling below min_score by swapping with the current last
//               element.
// IoU uses the reference's +1e-6 length epsilon on areas.
//
// Build: g++ -O3 -shared -fPIC -o libnms1d.so nms1d.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// segs: (n, 2) row-major [x1, x2]; out_idx: capacity n.
// Returns the number of kept indices, written to out_idx in descending
// score order.
int64_t nms1d(const float* segs, const float* scores, int64_t n,
              float iou_thresh, int64_t* out_idx) {
  if (n <= 0) return 0;
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return scores[a] > scores[b];
  });

  std::vector<float> area(n);
  for (int64_t i = 0; i < n; ++i)
    area[i] = segs[2 * i + 1] - segs[2 * i] + 1e-6f;

  std::vector<char> keep(n, 1);
  int64_t n_out = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    if (!keep[oi]) continue;
    const int64_t i = order[oi];
    out_idx[n_out++] = i;
    const float ix1 = segs[2 * i], ix2 = segs[2 * i + 1], ia = area[i];
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      if (!keep[oj]) continue;
      const int64_t j = order[oj];
      const float xx1 = std::max(ix1, segs[2 * j]);
      const float xx2 = std::min(ix2, segs[2 * j + 1]);
      const float inter = std::max(0.0f, xx2 - xx1);
      const float ovr = inter / (ia + area[j] - inter);
      if (ovr >= iou_thresh) keep[oj] = 0;
    }
  }
  return n_out;
}

// dets: (n, 3) output buffer [x1, x2, decayed_score] in selection order;
// out_idx: original indices of surviving segments in selection order.
// Returns the number of surviving segments.
int64_t softnms1d(const float* segs, const float* scores, int64_t n,
                  float sigma, float min_score, float* dets,
                  int64_t* out_idx) {
  if (n <= 0) return 0;
  std::vector<float> x1(n), x2(n), sc(n), area(n);
  std::vector<int64_t> ind(n);
  for (int64_t i = 0; i < n; ++i) {
    x1[i] = segs[2 * i];
    x2[i] = segs[2 * i + 1];
    sc[i] = scores[i];
    area[i] = x2[i] - x1[i] + 1e-6f;
    ind[i] = i;
  }

  int64_t live = n;  // shrinks as segments are dropped
  for (int64_t i = 0; i < live; ++i) {
    // selection: find the max-score segment among [i, live)
    int64_t max_pos = i;
    for (int64_t p = i + 1; p < live; ++p)
      if (sc[p] > sc[max_pos]) max_pos = p;

    // swap it into slot i and emit it
    std::swap(x1[i], x1[max_pos]);
    std::swap(x2[i], x2[max_pos]);
    std::swap(sc[i], sc[max_pos]);
    std::swap(area[i], area[max_pos]);
    std::swap(ind[i], ind[max_pos]);
    dets[3 * i + 0] = x1[i];
    dets[3 * i + 1] = x2[i];
    dets[3 * i + 2] = sc[i];

    // decay the rest; drop those falling below min_score by swapping with
    // the current last live element
    const float ix1 = x1[i], ix2 = x2[i], ia = area[i];
    for (int64_t p = i + 1; p < live; ++p) {
      const float xx1 = std::max(ix1, x1[p]);
      const float xx2 = std::min(ix2, x2[p]);
      const float inter = std::max(0.0f, xx2 - xx1);
      const float ovr = inter / (ia + area[p] - inter);

      sc[p] *= std::exp(-(ovr * ovr) / sigma);

      if (sc[p] < min_score) {
        const int64_t last = live - 1;
        x1[p] = x1[last];
        x2[p] = x2[last];
        sc[p] = sc[last];
        area[p] = area[last];
        ind[p] = ind[last];
        --live;
        --p;
      }
    }
  }
  for (int64_t i = 0; i < live; ++i) out_idx[i] = ind[i];
  return live;
}

}  // extern "C"
