// GIF89a encoder for the port's visual dumps (attention sweeps, turntables).
//
// The JAX package writes its GIFs through PIL (zeroshape_tpu/vis.py:237-240:
// `Image.save(format="GIF", save_all=True, duration=..., loop=0)`); the hosts
// the port runs on need not have PIL, so this file does the same job with the
// C++ standard library only. Built with g++ at first use and bound with ctypes
// (zeroshape_tpu_torch/gif.py).
//
// What it writes, as PIL does for RGB frames:
//   * one adaptive palette of at most 256 colours a frame: median cut over the
//     frame's distinct colours (the box of largest squared error is split at
//     the weighted median of its widest axis), each distinct colour then
//     mapped to its nearest palette entry;
//   * a frame equal to the one before it is dropped and its delay added to
//     the earlier frame's; any other frame after the first is cropped to the
//     box of pixels that changed and drawn over the previous one (disposal 1);
//   * the NETSCAPE2.0 looping extension and one delay a frame, in
//     hundredths of a second (PIL's int(duration / 10)).
// Pixel data is LZW with 8-bit minimum code size, cleared when the code table
// fills, in 255-byte sub-blocks. Frames are quantised and compressed on up to
// 8 threads.

#include <algorithm>
#include <array>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Entry {
  uint32_t rgb;    // r << 16 | g << 8 | b
  uint32_t count;  // pixels of this colour
};

inline int chan(uint32_t rgb, int axis) { return (rgb >> (16 - 8 * axis)) & 0xff; }

struct Box {
  int lo, hi;        // entries [lo, hi)
  double sse;        // weighted squared error about the mean, summed over the axes
  int axis;          // the axis of largest error
  uint8_t mean[3];
};

void measure(const std::vector<Entry>& e, Box& b) {
  double n = 0, s[3] = {0, 0, 0}, q[3] = {0, 0, 0};
  for (int i = b.lo; i < b.hi; ++i) {
    double c = e[i].count;
    n += c;
    for (int a = 0; a < 3; ++a) {
      double v = chan(e[i].rgb, a);
      s[a] += c * v;
      q[a] += c * v * v;
    }
  }
  b.sse = 0;
  b.axis = 0;
  double best = -1;
  for (int a = 0; a < 3; ++a) {
    double err = q[a] - s[a] * s[a] / n;
    b.sse += err;
    if (err > best) best = err, b.axis = a;
    b.mean[a] = (uint8_t)std::min(255.0, std::max(0.0, s[a] / n + 0.5));
  }
  if (b.hi - b.lo < 2) b.sse = 0;  // one colour: nothing to split
}

// Split b at the weighted median of its widest axis; false if it cannot split.
bool split(std::vector<Entry>& e, const Box& b, Box& left, Box& right) {
  uint64_t hist[256] = {0};
  uint64_t total = 0;
  int vmin = 255, vmax = 0;
  for (int i = b.lo; i < b.hi; ++i) {
    int v = chan(e[i].rgb, b.axis);
    hist[v] += e[i].count;
    total += e[i].count;
    vmin = std::min(vmin, v);
    vmax = std::max(vmax, v);
  }
  if (vmin == vmax) return false;
  uint64_t acc = 0;
  int cut = vmin;  // values <= cut go left; cut < vmax keeps the right side non-empty
  for (int v = vmin; v < vmax; ++v) {
    acc += hist[v];
    cut = v;
    if (2 * acc >= total) break;
  }
  int axis = b.axis;
  auto mid = std::partition(e.begin() + b.lo, e.begin() + b.hi,
                            [axis, cut](const Entry& x) { return chan(x.rgb, axis) <= cut; });
  int m = (int)(mid - e.begin());
  left.lo = b.lo, left.hi = m;
  right.lo = m, right.hi = b.hi;
  measure(e, left);
  measure(e, right);
  return true;
}

// Distinct colours of a frame: open addressing over 24-bit keys, sized to at
// least twice the pixels so that it stays small enough for the cache.
struct ColourHash {
  std::vector<uint32_t> keys, vals;
  uint32_t mask = 0;
  static constexpr uint32_t kEmpty = 0xFFFFFFFFu;  // never a 24-bit colour
  explicit ColourHash(size_t pixels) {
    size_t cap = 1024;
    while (cap < 2 * pixels) cap <<= 1;
    keys.assign(cap, kEmpty);
    vals.assign(cap, 0);
    mask = (uint32_t)(cap - 1);
  }
  // the slot of `key`, inserted with value 0 if absent; `fresh` says which
  uint32_t slot(uint32_t key, bool& fresh) {
    uint32_t s = (key * 0x9E3779B1u) >> 7 & mask;
    while (keys[s] != key) {
      if (keys[s] == kEmpty) {
        keys[s] = key;
        fresh = true;
        return s;
      }
      s = (s + 1) & mask;
    }
    fresh = false;
    return s;
  }
};

// Quantise the w x h rectangle at (x0, y0) of an RGB frame of width W:
// writes the palette (3 * 256 bytes, unused entries 0) and one index a pixel.
// `hash` is empty on entry and left empty; `slots` holds w * h entries.
void quantise(const uint8_t* rgb, int W, int x0, int y0, int w, int h, ColourHash& hash,
              std::vector<uint32_t>& slots, uint8_t* palette, uint8_t* index) {
  std::vector<Entry> e;
  std::vector<uint32_t> entry_slot;
  for (int y = 0; y < h; ++y) {
    const uint8_t* p = rgb + ((size_t)(y0 + y) * W + x0) * 3;
    for (int x = 0; x < w; ++x, p += 3) {
      uint32_t key = (uint32_t)p[0] << 16 | (uint32_t)p[1] << 8 | p[2];
      bool fresh;
      uint32_t s = hash.slot(key, fresh);
      if (fresh) e.push_back({key, 0}), entry_slot.push_back(s);
      ++hash.vals[s];
      slots[(size_t)y * w + x] = s;
    }
  }
  for (size_t i = 0; i < e.size(); ++i) e[i].count = hash.vals[entry_slot[i]];
  std::vector<Box> boxes(1);
  boxes[0].lo = 0, boxes[0].hi = (int)e.size();
  measure(e, boxes[0]);
  while (boxes.size() < 256) {
    int pick = -1;
    double best = 0;
    for (int i = 0; i < (int)boxes.size(); ++i)
      if (boxes[i].sse > best) best = boxes[i].sse, pick = i;
    if (pick < 0) break;  // every box holds one colour
    Box l, r;
    if (!split(e, boxes[pick], l, r)) {
      boxes[pick].sse = 0;
      continue;
    }
    boxes[pick] = l;
    boxes.push_back(r);
  }
  int n_pal = (int)boxes.size();
  std::memset(palette, 0, 3 * 256);
  for (int i = 0; i < n_pal; ++i)
    for (int a = 0; a < 3; ++a) palette[3 * i + a] = boxes[i].mean[a];
  // nearest palette entry of each distinct colour: the entries sorted by their
  // channel sum, searched outward from the colour's own sum until the sum gap
  // alone (squared / 3 bounds the distance) exceeds the best distance found
  std::vector<std::pair<int, int>> order(n_pal);
  for (int i = 0; i < n_pal; ++i)
    order[i] = {palette[3 * i] + palette[3 * i + 1] + palette[3 * i + 2], i};
  std::sort(order.begin(), order.end());
  for (int bi = 0; bi < n_pal; ++bi) {
    for (int k = boxes[bi].lo; k < boxes[bi].hi; ++k) {
      uint32_t key = e[k].rgb;
      int c0 = chan(key, 0), c1 = chan(key, 1), c2 = chan(key, 2);
      int sum = c0 + c1 + c2;
      auto dist = [&](int i) {
        int d0 = palette[3 * i] - c0, d1 = palette[3 * i + 1] - c1, d2 = palette[3 * i + 2] - c2;
        return d0 * d0 + d1 * d1 + d2 * d2;
      };
      int best_i = bi, best_d = dist(bi);
      int start = (int)(std::lower_bound(order.begin(), order.end(), std::make_pair(sum, -1)) - order.begin());
      for (int j = start; j < n_pal; ++j) {
        int g = order[j].first - sum;
        if (g * g > 3 * best_d) break;
        int d = dist(order[j].second);
        if (d < best_d || (d == best_d && order[j].second < best_i)) best_d = d, best_i = order[j].second;
      }
      for (int j = start - 1; j >= 0; --j) {
        int g = sum - order[j].first;
        if (g * g > 3 * best_d) break;
        int d = dist(order[j].second);
        if (d < best_d || (d == best_d && order[j].second < best_i)) best_d = d, best_i = order[j].second;
      }
      bool fresh;
      hash.vals[hash.slot(key, fresh)] = (uint32_t)best_i;
    }
  }
  for (size_t i = 0, n = (size_t)w * h; i < n; ++i) index[i] = (uint8_t)hash.vals[slots[i]];
  for (uint32_t s : entry_slot) hash.keys[s] = ColourHash::kEmpty, hash.vals[s] = 0;
}

struct Writer {
  std::vector<uint8_t> buf;
  void byte(int b) { buf.push_back((uint8_t)b); }
  void u16(int v) { byte(v & 0xff), byte(v >> 8 & 0xff); }
  void bytes(const void* p, size_t k) { buf.insert(buf.end(), (const uint8_t*)p, (const uint8_t*)p + k); }
};

// LZW-compress `n` 8-bit indices and write them as image data sub-blocks.
void lzw(Writer& w, const uint8_t* index, int64_t n, std::vector<uint16_t>& tree) {
  const int min_size = 8, clear = 1 << min_size;
  std::vector<uint8_t> data;
  uint32_t acc = 0;
  int bits = 0;
  auto put = [&](uint32_t code, int size) {
    acc |= code << bits;
    bits += size;
    while (bits >= 8) data.push_back(acc & 0xff), acc >>= 8, bits -= 8;
  };
  std::fill(tree.begin(), tree.end(), 0);
  int size = min_size + 1, max_code = clear + 1;
  put(clear, size);
  int cur = -1;
  for (int64_t i = 0; i < n; ++i) {
    int v = index[i];
    if (cur < 0) {
      cur = v;
    } else if (tree[(size_t)cur * 256 + v]) {
      cur = tree[(size_t)cur * 256 + v];
    } else {
      put(cur, size);
      tree[(size_t)cur * 256 + v] = (uint16_t)(++max_code);
      if (max_code >= (1 << size)) ++size;
      if (max_code == 4095) {
        put(clear, size);
        std::fill(tree.begin(), tree.end(), 0);
        size = min_size + 1;
        max_code = clear + 1;
      }
      cur = v;
    }
  }
  if (cur >= 0) put(cur, size);
  put(clear, size);
  put(clear + 1, min_size + 1);
  if (bits > 0) data.push_back(acc & 0xff);
  w.byte(min_size);
  for (size_t i = 0; i < data.size(); i += 255) {
    int k = (int)std::min<size_t>(255, data.size() - i);
    w.byte(k);
    w.bytes(data.data() + i, k);
  }
  w.byte(0);
}

}  // namespace

extern "C" {

// Encode `n` RGB frames ([n, H, W, 3] uint8, C order) shown `delay_cs[i]`
// hundredths of a second each into `out` (capacity `cap` bytes). Returns the
// GIF's size in bytes: larger than `cap` when it did not fit (nothing is
// written then), -1 for bad arguments.
int64_t zs_gif_encode(const uint8_t* frames, int n, int H, int W, const int* delay_cs, uint8_t* out,
                      int64_t cap) {
  if (n < 1 || H < 1 || W < 1 || H > 65535 || W > 65535) return -1;
  const size_t frame_bytes = (size_t)H * W * 3;
  // which frames survive (differ from the one before), their delays and boxes
  struct Rect { int idx, x0, y0, w, h, delay; };
  std::vector<Rect> keep;
  keep.push_back({0, 0, 0, W, H, delay_cs[0]});
  for (int i = 1; i < n; ++i) {
    const uint8_t* a = frames + frame_bytes * (i - 1);
    const uint8_t* b = frames + frame_bytes * i;
    int x0 = W, y0 = H, x1 = -1, y1 = -1;
    for (int y = 0; y < H; ++y) {
      const uint8_t* ra = a + (size_t)y * W * 3;
      const uint8_t* rb = b + (size_t)y * W * 3;
      if (std::memcmp(ra, rb, (size_t)W * 3) == 0) continue;
      int l = 0, r = W - 1;
      while (std::memcmp(ra + 3 * l, rb + 3 * l, 3) == 0) ++l;
      while (std::memcmp(ra + 3 * r, rb + 3 * r, 3) == 0) --r;
      x0 = std::min(x0, l), x1 = std::max(x1, r);
      y0 = std::min(y0, y), y1 = y;
    }
    if (x1 < 0) {
      keep.back().delay += delay_cs[i];
      continue;
    }
    keep.push_back({i, x0, y0, x1 - x0 + 1, y1 - y0 + 1, delay_cs[i]});
  }

  // each frame's blocks are independent once its box is known: encode them
  // on up to 8 threads, then join the blocks in order
  std::vector<Writer> blocks(keep.size());
  std::vector<std::array<uint8_t, 3 * 256>> palettes(keep.size());
  std::atomic<size_t> next{0};
  auto worker = [&]() {
    ColourHash hash((size_t)H * W);
    std::vector<uint32_t> slots((size_t)H * W);
    std::vector<uint16_t> tree((size_t)4096 * 256);
    std::vector<uint8_t> index((size_t)H * W);
    for (size_t k; (k = next.fetch_add(1)) < keep.size();) {
      const Rect& r = keep[k];
      uint8_t* palette = palettes[k].data();
      quantise(frames + frame_bytes * r.idx, W, r.x0, r.y0, r.w, r.h, hash, slots, palette, index.data());
      Writer& w = blocks[k];
      w.byte(0x21), w.byte(0xF9), w.byte(4);  // graphic control: disposal 1, no transparency
      w.byte(1 << 2), w.u16(r.delay), w.byte(0), w.byte(0);
      w.byte(0x2C);
      w.u16(r.x0), w.u16(r.y0), w.u16(r.w), w.u16(r.h);
      if (k == 0) {
        w.byte(0);  // the first frame's palette is the global table
      } else {
        w.byte(0x87);  // a local table of 256 entries
        w.bytes(palette, 3 * 256);
      }
      lzw(w, index.data(), (int64_t)r.w * r.h, tree);
    }
  };
  unsigned n_threads = std::max(1u, std::min({std::thread::hardware_concurrency(), 8u, (unsigned)keep.size()}));
  std::vector<std::thread> pool;
  for (unsigned t = 1; t < n_threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();

  Writer head;  // logical screen, the global table, the looping extension
  head.bytes("GIF89a", 6);
  head.u16(W), head.u16(H);
  head.byte(0xF7), head.byte(0), head.byte(0);
  head.bytes(palettes[0].data(), 3 * 256);
  head.byte(0x21), head.byte(0xFF), head.byte(11);
  head.bytes("NETSCAPE2.0", 11);
  head.byte(3), head.byte(1), head.u16(0), head.byte(0);  // loop forever
  int64_t size = (int64_t)head.buf.size() + 1;
  for (auto& w : blocks) size += (int64_t)w.buf.size();
  if (size > cap) return size;
  uint8_t* p = out;
  p = std::copy(head.buf.begin(), head.buf.end(), p);
  for (auto& w : blocks) p = std::copy(w.buf.begin(), w.buf.end(), p);
  *p = 0x3B;
  return size;
}

}  // extern "C"
