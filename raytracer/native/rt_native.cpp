// Native runtime for raytracer: host-side BVH build + PNG encode.
//
// The reference keeps its whole runtime in native code (Rust); here the
// device compute path is JAX/XLA, and the host runtime pieces that are
// latency-sensitive at scene-build/IO time are C++: BVH construction over
// primitive AABBs (bvh.rs:60-83's role, largest-extent median split, same
// flat layout as ops/bvh.py::_build_flat_python) and PNG encoding
// (image-crate role, main.rs:55). Exposed as a C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 rt_native.cpp -o librt_native.so -lz
// (falls back to -DRT_NO_ZLIB with store-mode deflate if zlib is absent).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifndef RT_NO_ZLIB
#include <zlib.h>
#endif

extern "C" {

// ------------------------------------------------------------------ BVH

// Flat-layout contract (shared with the Python fallback):
//   interior: left/right = child node ids, is_leaf = 0
//   leaf:     left = first index into `order`, right = prim count, is_leaf = 1
// Returns the number of nodes written, or -1 on error.
int rt_bvh_build(const float* pmin, const float* pmax, int n,
                 float* node_min, float* node_max,
                 int* left, int* right, int* is_leaf,
                 int* order, int leaf_size) {
  if (n <= 0 || leaf_size < 1) return -1;
  const int max_nodes = 2 * n;  // binary tree with >=1 prim per leaf
  std::vector<float> cx(n), cy(n), cz(n);
  for (int i = 0; i < n; i++) {
    cx[i] = 0.5f * (pmin[3 * i + 0] + pmax[3 * i + 0]);
    cy[i] = 0.5f * (pmin[3 * i + 1] + pmax[3 * i + 1]);
    cz[i] = 0.5f * (pmin[3 * i + 2] + pmax[3 * i + 2]);
  }
  for (int i = 0; i < n; i++) order[i] = i;

  struct Task { int nid, s, e; };
  std::vector<Task> stack;
  stack.reserve(64);
  int n_nodes = 1;
  stack.push_back({0, 0, n});

  while (!stack.empty()) {
    Task t = stack.back();
    stack.pop_back();
    float bmin[3] = {1e30f, 1e30f, 1e30f};
    float bmax[3] = {-1e30f, -1e30f, -1e30f};
    float cmin[3] = {1e30f, 1e30f, 1e30f};
    float cmax[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = t.s; i < t.e; i++) {
      const int p = order[i];
      const float c[3] = {cx[p], cy[p], cz[p]};
      for (int a = 0; a < 3; a++) {
        bmin[a] = std::min(bmin[a], pmin[3 * p + a]);
        bmax[a] = std::max(bmax[a], pmax[3 * p + a]);
        cmin[a] = std::min(cmin[a], c[a]);
        cmax[a] = std::max(cmax[a], c[a]);
      }
    }
    std::memcpy(node_min + 3 * t.nid, bmin, sizeof bmin);
    std::memcpy(node_max + 3 * t.nid, bmax, sizeof bmax);

    const int count = t.e - t.s;
    if (count <= leaf_size) {
      left[t.nid] = t.s;
      right[t.nid] = count;
      is_leaf[t.nid] = 1;
      continue;
    }
    int axis = 0;
    float best_ext = -1.0f;
    for (int a = 0; a < 3; a++) {
      const float ext = cmax[a] - cmin[a];
      if (ext > best_ext) { best_ext = ext; axis = a; }
    }
    const float* cc = axis == 0 ? cx.data() : (axis == 1 ? cy.data() : cz.data());
    int* beg = order + t.s;
    int* mid = beg + count / 2;
    int* end = order + t.e;
    std::nth_element(beg, mid, end,
                     [cc](int a, int b) { return cc[a] < cc[b]; });

    if (n_nodes + 2 > max_nodes) return -1;
    const int l_id = n_nodes++;
    const int r_id = n_nodes++;
    left[t.nid] = l_id;
    right[t.nid] = r_id;
    is_leaf[t.nid] = 0;
    stack.push_back({r_id, t.s + count / 2, t.e});
    stack.push_back({l_id, t.s, t.s + count / 2});
  }
  return n_nodes;
}

// ------------------------------------------------------------------ PNG

static uint32_t crc_table[256];
static bool crc_init_done = false;

static void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

static uint32_t crc32_update(uint32_t crc, const uint8_t* buf, size_t len) {
  if (!crc_init_done) crc_init();
  crc ^= 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++)
    crc = crc_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

static void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(uint8_t(v >> 24));
  out.push_back(uint8_t(v >> 16));
  out.push_back(uint8_t(v >> 8));
  out.push_back(uint8_t(v));
}

static void put_chunk(std::vector<uint8_t>& out, const char tag[4],
                      const uint8_t* data, size_t len) {
  put_be32(out, uint32_t(len));
  const size_t tag_pos = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  const uint32_t crc = crc32_update(0, out.data() + tag_pos, len + 4);
  put_be32(out, crc);
}

#ifdef RT_NO_ZLIB
// Store-mode "deflate": raw blocks + adler32. Valid zlib stream, ratio 1.
static std::vector<uint8_t> deflate_stored(const uint8_t* raw, size_t len) {
  std::vector<uint8_t> z;
  z.push_back(0x78); z.push_back(0x01);
  size_t off = 0;
  while (off < len) {
    const size_t blk = std::min<size_t>(65535, len - off);
    z.push_back(off + blk >= len ? 1 : 0);
    z.push_back(uint8_t(blk & 0xFF)); z.push_back(uint8_t(blk >> 8));
    z.push_back(uint8_t(~blk & 0xFF)); z.push_back(uint8_t((~blk >> 8) & 0xFF));
    z.insert(z.end(), raw + off, raw + off + blk);
    off += blk;
  }
  uint32_t a = 1, b = 0;
  for (size_t i = 0; i < len; i++) {
    a = (a + raw[i]) % 65521;
    b = (b + a) % 65521;
  }
  put_be32(z, (b << 16) | a);
  return z;
}
#endif

int rt_write_png(const char* path, const unsigned char* rgb, int w, int h) {
  if (w <= 0 || h <= 0) return -1;
  // Filter 0 (None) per scanline.
  std::vector<uint8_t> raw;
  raw.reserve(size_t(h) * (size_t(w) * 3 + 1));
  for (int y = 0; y < h; y++) {
    raw.push_back(0);
    raw.insert(raw.end(), rgb + size_t(y) * w * 3, rgb + size_t(y + 1) * w * 3);
  }
#ifdef RT_NO_ZLIB
  std::vector<uint8_t> z = deflate_stored(raw.data(), raw.size());
#else
  uLongf zcap = compressBound(raw.size());
  std::vector<uint8_t> z(zcap);
  if (compress2(z.data(), &zcap, raw.data(), raw.size(), 6) != Z_OK) return -2;
  z.resize(zcap);
#endif
  std::vector<uint8_t> out;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = uint8_t(w >> 24); ihdr[1] = uint8_t(w >> 16);
  ihdr[2] = uint8_t(w >> 8);  ihdr[3] = uint8_t(w);
  ihdr[4] = uint8_t(h >> 24); ihdr[5] = uint8_t(h >> 16);
  ihdr[6] = uint8_t(h >> 8);  ihdr[7] = uint8_t(h);
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
  put_chunk(out, "IDAT", z.data(), z.size());
  put_chunk(out, "IEND", nullptr, 0);

  FILE* f = std::fopen(path, "wb");
  if (!f) return -3;
  const size_t written = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return written == out.size() ? 0 : -4;
}

}  // extern "C"
