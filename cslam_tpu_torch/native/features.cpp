// Native local-feature extraction for the visual front end.
//
// Plays the role rtabmap's Feature2D plays in the reference
// (src/front_end/rgbd_handler.cpp:266-312): per-keyframe keypoint
// detection + binary descriptor extraction on the host, feeding the
// device-side matching/verification kernels. Host C++ is the right tool
// here — the work is branchy, pointer-chasing, per-pixel integer code.
//
// Contents:
//   - FAST-9 corner detector with non-maximum suppression
//   - BRIEF-256 binary descriptors over box-smoothed intensities
//     (integral-image based)
//   - ORB-style steered BRIEF: intensity-centroid keypoint orientation
//     (radius-15 circular patch moments) rotating the sampling pattern,
//     for viewpoint robustness across robots (in-plane rotation between
//     robots silently kills unsteered-BRIEF loop closures)
//   - grid-stratified keypoint selection (keeps spatial coverage)
//
// Exposed with a plain C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Bresenham circle of radius 3 (the FAST ring), 16 offsets.
const int kRing[16][2] = {
    {0, -3},  {1, -3},  {2, -2},  {3, -1},  {3, 0},  {3, 1},
    {2, 2},   {1, 3},   {0, 3},   {-1, 3},  {-2, 2}, {-3, 1},
    {-3, 0},  {-3, -1}, {-2, -2}, {-1, -3}};

inline const uint8_t* px(const uint8_t* img, int stride, int x, int y) {
  return img + y * stride + x;
}

// FAST-9 segment test: >= 9 contiguous ring pixels all brighter than
// center+t or all darker than center-t.
bool fast_corner(const uint8_t* img, int stride, int x, int y, int t,
                 int* score_out) {
  const int c = *px(img, stride, x, y);
  int ring[16];
  for (int i = 0; i < 16; ++i)
    ring[i] = *px(img, stride, x + kRing[i][0], y + kRing[i][1]);

  for (int sign = 0; sign < 2; ++sign) {
    int run = 0, best_run = 0;
    int score = 0;
    for (int i = 0; i < 32; ++i) {  // wrap twice for circularity
      const int v = ring[i & 15];
      const bool on = sign ? (v > c + t) : (v < c - t);
      if (on) {
        if (++run > best_run) best_run = run;
      } else {
        run = 0;
      }
      if (i < 16) score += std::abs(v - c);
    }
    if (best_run >= 9) {
      *score_out = score;
      return true;
    }
  }
  return false;
}

struct Keypoint {
  int x, y, score;
};

void integral_image(const uint8_t* img, int h, int w,
                    std::vector<uint32_t>* integral) {
  integral->assign((h + 1) * (w + 1), 0);
  uint32_t* out = integral->data();
  const int ow = w + 1;
  for (int y = 0; y < h; ++y) {
    uint32_t row = 0;
    for (int x = 0; x < w; ++x) {
      row += img[y * w + x];
      out[(y + 1) * ow + (x + 1)] = out[y * ow + (x + 1)] + row;
    }
  }
}

inline int box_mean(const std::vector<uint32_t>& integral, int w, int x,
                    int y, int r) {
  const int ow = w + 1;
  const int x0 = x - r, y0 = y - r, x1 = x + r + 1, y1 = y + r + 1;
  const uint32_t sum = integral[y1 * ow + x1] - integral[y0 * ow + x1] -
                       integral[y1 * ow + x0] + integral[y0 * ow + x0];
  const int area = (2 * r + 1) * (2 * r + 1);
  return static_cast<int>(sum / area);
}

// Deterministic BRIEF sampling pattern: 256 point pairs in a 31x31 patch,
// from a fixed LCG so Python-side tests can regenerate it.
void brief_pattern(int pairs, std::vector<int>* pattern) {
  uint64_t state = 0x853c49e6748fea9bULL;
  pattern->resize(pairs * 4);
  auto next = [&state]() {
    state = state * 6364136223846793005ULL + 1442695040888963407ULL;
    return static_cast<int>((state >> 33) % 27) - 13;  // [-13, 13]
  };
  for (int i = 0; i < pairs * 4; ++i) (*pattern)[i] = next();
}

// Intensity-centroid orientation (ORB): angle of the patch centroid
// relative to the keypoint over a radius-15 circular patch.
double keypoint_angle(const uint8_t* img, int stride, int x, int y) {
  const int r = 15;
  long m01 = 0, m10 = 0;
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx) {
      if (dx * dx + dy * dy > r * r) continue;
      const int v = *px(img, stride, x + dx, y + dy);
      m10 += static_cast<long>(dx) * v;
      m01 += static_cast<long>(dy) * v;
    }
  }
  return std::atan2(static_cast<double>(m01), static_cast<double>(m10));
}

// round-half-away-from-zero free version: floor(v + 0.5) — matches the
// numpy fallback exactly (np.floor(v + 0.5)), unlike std::round vs
// np.rint (round-half-even) which differ at exact .5
inline int round_half_up(double v) {
  return static_cast<int>(std::floor(v + 0.5));
}

}  // namespace

extern "C" {

// Detect up to max_kp FAST-9 corners with 3x3 non-max suppression and
// grid-stratified selection over a cells x cells grid.
// out_xy: int32[max_kp*2], out_score: int32[max_kp]; returns count.
int cslam_fast_detect(const uint8_t* img, int h, int w, int threshold,
                      int max_kp, int grid_cells, int32_t* out_xy,
                      int32_t* out_score) {
  if (h < 8 || w < 8) return 0;
  std::vector<int> scores(h * w, 0);
  std::vector<Keypoint> kps;
  kps.reserve(4096);
  for (int y = 3; y < h - 3; ++y) {
    for (int x = 3; x < w - 3; ++x) {
      int score;
      if (fast_corner(img, w, x, y, threshold, &score)) {
        scores[y * w + x] = score;
      }
    }
  }
  // 3x3 non-max suppression
  for (int y = 4; y < h - 4; ++y) {
    for (int x = 4; x < w - 4; ++x) {
      const int s = scores[y * w + x];
      if (s == 0) continue;
      bool is_max = true;
      for (int dy = -1; dy <= 1 && is_max; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          if (dx == 0 && dy == 0) continue;
          if (scores[(y + dy) * w + x + dx] > s) {
            is_max = false;
            break;
          }
        }
      if (is_max) kps.push_back({x, y, s});
    }
  }

  // grid-stratified top-score selection for spatial coverage
  const int cells = std::max(grid_cells, 1);
  const int per_cell = std::max(max_kp / (cells * cells), 1);
  std::vector<std::vector<Keypoint>> grid(cells * cells);
  for (const auto& kp : kps) {
    const int cx = std::min(kp.x * cells / w, cells - 1);
    const int cy = std::min(kp.y * cells / h, cells - 1);
    grid[cy * cells + cx].push_back(kp);
  }
  std::vector<Keypoint> selected;
  selected.reserve(max_kp);
  std::vector<Keypoint> overflow;
  for (auto& cell : grid) {
    std::sort(cell.begin(), cell.end(),
              [](const Keypoint& a, const Keypoint& b) {
                return a.score > b.score;
              });
    for (size_t i = 0; i < cell.size(); ++i) {
      if (static_cast<int>(i) < per_cell)
        selected.push_back(cell[i]);
      else
        overflow.push_back(cell[i]);
    }
  }
  if (static_cast<int>(selected.size()) < max_kp) {
    std::sort(overflow.begin(), overflow.end(),
              [](const Keypoint& a, const Keypoint& b) {
                return a.score > b.score;
              });
    for (const auto& kp : overflow) {
      if (static_cast<int>(selected.size()) >= max_kp) break;
      selected.push_back(kp);
    }
  }
  if (static_cast<int>(selected.size()) > max_kp) selected.resize(max_kp);

  for (size_t i = 0; i < selected.size(); ++i) {
    out_xy[2 * i] = selected[i].x;
    out_xy[2 * i + 1] = selected[i].y;
    out_score[i] = selected[i].score;
  }
  return static_cast<int>(selected.size());
}

// BRIEF-256 descriptors (32 bytes per keypoint) over 5x5 box-smoothed
// intensities. Keypoints closer than 16 px to the border get zero
// descriptors (flagged via return mask semantics: descriptor stays zero).
void cslam_brief_describe(const uint8_t* img, int h, int w,
                          const int32_t* kp_xy, int n_kp,
                          uint8_t* out_desc /* n_kp*32 */) {
  std::vector<uint32_t> integral;
  integral_image(img, h, w, &integral);
  std::vector<int> pattern;
  brief_pattern(256, &pattern);
  std::memset(out_desc, 0, static_cast<size_t>(n_kp) * 32);

  for (int k = 0; k < n_kp; ++k) {
    const int x = kp_xy[2 * k], y = kp_xy[2 * k + 1];
    if (x < 16 || y < 16 || x >= w - 16 || y >= h - 16) continue;
    uint8_t* d = out_desc + k * 32;
    for (int b = 0; b < 256; ++b) {
      const int ax = x + pattern[4 * b], ay = y + pattern[4 * b + 1];
      const int bx = x + pattern[4 * b + 2], by = y + pattern[4 * b + 3];
      const int va = box_mean(integral, w, ax, ay, 2);
      const int vb = box_mean(integral, w, bx, by, 2);
      if (va < vb) d[b >> 3] |= (1 << (b & 7));
    }
  }
}

// ORB-style steered BRIEF-256: the sampling pattern is rotated by each
// keypoint's intensity-centroid orientation before sampling, making the
// descriptor invariant to in-plane rotation (rtabmap Feature2D's ORB
// role at reference rgbd_handler.cpp:266-312). Keypoints within 24 px of
// the border (rotated pattern reach 13*sqrt(2) + box radius, plus the
// radius-15 moment patch) get zero descriptors and angle 0.
// out_desc: n_kp*32 bytes; out_angle: float[n_kp] radians.
void cslam_steered_brief_describe(const uint8_t* img, int h, int w,
                                  const int32_t* kp_xy, int n_kp,
                                  uint8_t* out_desc, float* out_angle) {
  std::vector<uint32_t> integral;
  integral_image(img, h, w, &integral);
  std::vector<int> pattern;
  brief_pattern(256, &pattern);
  std::memset(out_desc, 0, static_cast<size_t>(n_kp) * 32);

  for (int k = 0; k < n_kp; ++k) {
    const int x = kp_xy[2 * k], y = kp_xy[2 * k + 1];
    out_angle[k] = 0.0f;
    if (x < 24 || y < 24 || x >= w - 24 || y >= h - 24) continue;
    const double a = keypoint_angle(img, w, x, y);
    out_angle[k] = static_cast<float>(a);
    const double c = std::cos(a), s = std::sin(a);
    uint8_t* d = out_desc + k * 32;
    for (int b = 0; b < 256; ++b) {
      const int pax = pattern[4 * b], pay = pattern[4 * b + 1];
      const int pbx = pattern[4 * b + 2], pby = pattern[4 * b + 3];
      const int ax = x + round_half_up(c * pax - s * pay);
      const int ay = y + round_half_up(s * pax + c * pay);
      const int bx = x + round_half_up(c * pbx - s * pby);
      const int by = y + round_half_up(s * pbx + c * pby);
      const int va = box_mean(integral, w, ax, ay, 2);
      const int vb = box_mean(integral, w, bx, by, 2);
      if (va < vb) d[b >> 3] |= (1 << (b & 7));
    }
  }
}

// Mutual-nearest-neighbor hamming matching between two descriptor sets,
// with an optional Lowe ratio test (ratio <= 0 disables: a best match is
// kept only when best_dist <= ratio * second_best_dist).
// out_pairs: int32[max_pairs*2]; returns the number of mutual matches with
// distance <= max_dist.
int cslam_hamming_match(const uint8_t* desc_a, int n_a, const uint8_t* desc_b,
                        int n_b, int max_dist, float ratio,
                        int32_t* out_pairs, int max_pairs) {
  if (n_a == 0 || n_b == 0) return 0;
  // all-zero descriptors are the "too close to the border" sentinel from
  // the describers; they would otherwise mutually match at distance 0
  auto nonzero = [](const uint64_t* d) {
    return (d[0] | d[1] | d[2] | d[3]) != 0;
  };
  std::vector<int> best_ab(n_a, -1), dist_ab(n_a, 1 << 30);
  std::vector<int> second_ab(n_a, 1 << 30);
  std::vector<int> best_ba(n_b, -1), dist_ba(n_b, 1 << 30);
  for (int i = 0; i < n_a; ++i) {
    const uint64_t* a = reinterpret_cast<const uint64_t*>(desc_a + i * 32);
    if (!nonzero(a)) continue;
    for (int j = 0; j < n_b; ++j) {
      const uint64_t* b = reinterpret_cast<const uint64_t*>(desc_b + j * 32);
      if (!nonzero(b)) continue;
      int d = 0;
      for (int q = 0; q < 4; ++q) d += __builtin_popcountll(a[q] ^ b[q]);
      if (d < dist_ab[i]) {
        second_ab[i] = dist_ab[i];
        dist_ab[i] = d;
        best_ab[i] = j;
      } else if (d < second_ab[i]) {
        second_ab[i] = d;
      }
      if (d < dist_ba[j]) {
        dist_ba[j] = d;
        best_ba[j] = i;
      }
    }
  }
  int count = 0;
  for (int i = 0; i < n_a && count < max_pairs; ++i) {
    const int j = best_ab[i];
    if (j < 0 || best_ba[j] != i || dist_ab[i] > max_dist) continue;
    if (ratio > 0.0f &&
        static_cast<float>(dist_ab[i]) >
            ratio * static_cast<float>(second_ab[i]))
      continue;
    out_pairs[2 * count] = i;
    out_pairs[2 * count + 1] = j;
    ++count;
  }
  return count;
}

}  // extern "C"
