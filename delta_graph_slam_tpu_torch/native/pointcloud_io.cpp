// Native host I/O engine for point-cloud data.
//
// The reference's runtime is C++ (PCL pcd IO, rosbag deserialization);
// this is the host-side data path of the PyTorch port, a copy of the JAX
// package's native/pointcloud_io.cpp: zero-copy KITTI .bin ingestion,
// binary PCD read/write, a packed scan-queue spool used by the replay
// driver, and host voxel thinning. Exposed to Python over a plain C ABI
// (ctypes, native/__init__.py); the arrays feed straight into device
// buffers.
//
// Build: native/__init__.py:build() runs
//   g++ -O3 -fPIC -shared -std=c++17 -o _build/libdgs_pcio_<hash>.so pointcloud_io.cpp
// at first use.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------- KITTI bin
// KITTI raw velodyne scans: packed float32 x,y,z,reflectance records.
// Returns the number of points, fills *out (malloc'd, caller frees via
// pcio_free) with xyz triplets (reflectance dropped, stride compacted).
int64_t pcio_load_kitti_bin(const char* path, float** out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  size_t bytes = static_cast<size_t>(st.st_size);
  size_t n = bytes / (4 * sizeof(float));
  if (n == 0) { close(fd); *out = nullptr; return 0; }
  void* mapped = mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (mapped == MAP_FAILED) return -1;
  const float* src = static_cast<const float*>(mapped);
  float* dst = static_cast<float*>(malloc(n * 3 * sizeof(float)));
  if (!dst) { munmap(mapped, bytes); return -1; }
  for (size_t i = 0; i < n; ++i) {
    dst[i * 3 + 0] = src[i * 4 + 0];
    dst[i * 3 + 1] = src[i * 4 + 1];
    dst[i * 3 + 2] = src[i * 4 + 2];
  }
  munmap(mapped, bytes);
  *out = dst;
  return static_cast<int64_t>(n);
}

void pcio_free(void* p) { free(p); }

// ------------------------------------------------------------------- PCD IO
// Binary PCD v0.7, FIELDS x y z, float32.
int pcio_save_pcd(const char* path, const float* xyz, int64_t n) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  char header[512];
  int hlen = snprintf(
      header, sizeof(header),
      "# .PCD v0.7 - Point Cloud Data file format\n"
      "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
      "WIDTH %lld\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS %lld\n"
      "DATA binary\n",
      static_cast<long long>(n), static_cast<long long>(n));
  if (fwrite(header, 1, hlen, f) != static_cast<size_t>(hlen)) {
    fclose(f);
    return -1;
  }
  if (n > 0 &&
      fwrite(xyz, sizeof(float), n * 3, f) != static_cast<size_t>(n * 3)) {
    fclose(f);
    return -1;
  }
  fclose(f);
  return 0;
}

// Parses header (ascii or binary xyz PCD); returns count, fills *out.
int64_t pcio_load_pcd(const char* path, float** out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[1024];
  long long n = -1;
  bool binary = false;
  long data_off = -1;
  while (fgets(line, sizeof(line), f)) {
    if (strncmp(line, "FIELDS", 6) == 0) {
      // only exactly "FIELDS x y z" matches the fixed 3-float stride
      // below; anything else (e.g. "FIELDS x y z intensity") returns -2
      // so the caller falls back to the Python reader, which handles
      // arbitrary field layouts.
      if (strncmp(line, "FIELDS x y z", 12) != 0) { fclose(f); return -2; }
      for (char* p = line + 12; *p; ++p) {
        if (*p != ' ' && *p != '\n' && *p != '\r') { fclose(f); return -2; }
      }
    } else if (strncmp(line, "POINTS", 6) == 0) {
      n = atoll(line + 7);
    } else if (strncmp(line, "DATA", 4) == 0) {
      binary = strncmp(line + 5, "binary", 6) == 0;
      data_off = ftell(f);
      break;
    }
  }
  if (n < 0 || data_off < 0) { fclose(f); return -1; }
  float* dst = static_cast<float*>(malloc(n * 3 * sizeof(float)));
  if (!dst) { fclose(f); return -1; }
  if (binary) {
    // file may have more fields per point; we only support xyz here
    if (fread(dst, sizeof(float), n * 3, f) != static_cast<size_t>(n * 3)) {
      free(dst);
      fclose(f);
      return -1;
    }
  } else {
    for (long long i = 0; i < n; ++i) {
      if (fscanf(f, "%f %f %f", &dst[i * 3], &dst[i * 3 + 1],
                 &dst[i * 3 + 2]) != 3) {
        free(dst);
        fclose(f);
        return -1;
      }
    }
  }
  fclose(f);
  *out = dst;
  return n;
}

// ------------------------------------------------------------- scan spool
// Append-only packed spool of variable-length float32 scans with stamps.
// The replay driver writes scans once and replays them repeatedly without
// re-parsing source datasets (the bag_player equivalent's storage layer).
struct Spool {
  FILE* f;
  std::vector<int64_t> offsets;  // record offsets (load mode)
  std::vector<int64_t> counts;
  std::vector<double> stamps;
};

void* pcio_spool_create(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Spool* s = new Spool();
  s->f = f;
  return s;
}

int pcio_spool_append(void* handle, double stamp, const float* xyz,
                      int64_t n) {
  Spool* s = static_cast<Spool*>(handle);
  if (fwrite(&stamp, sizeof(double), 1, s->f) != 1) return -1;
  if (fwrite(&n, sizeof(int64_t), 1, s->f) != 1) return -1;
  if (n > 0 &&
      fwrite(xyz, sizeof(float), n * 3, s->f) != static_cast<size_t>(n * 3))
    return -1;
  return 0;
}

void pcio_spool_close(void* handle) {
  Spool* s = static_cast<Spool*>(handle);
  if (s->f) fclose(s->f);
  delete s;
}

void* pcio_spool_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Spool* s = new Spool();
  s->f = f;
  // index records
  for (;;) {
    double stamp;
    int64_t n;
    long off = ftell(f);
    if (fread(&stamp, sizeof(double), 1, f) != 1) break;
    if (fread(&n, sizeof(int64_t), 1, f) != 1) break;
    s->offsets.push_back(off);
    s->counts.push_back(n);
    s->stamps.push_back(stamp);
    fseek(f, n * 3 * sizeof(float), SEEK_CUR);
  }
  return s;
}

int64_t pcio_spool_size(void* handle) {
  return static_cast<Spool*>(handle)->stamps.size();
}

double pcio_spool_stamp(void* handle, int64_t i) {
  return static_cast<Spool*>(handle)->stamps[i];
}

int64_t pcio_spool_count(void* handle, int64_t i) {
  return static_cast<Spool*>(handle)->counts[i];
}

// Reads record i into caller-provided buffer (count*3 floats).
int pcio_spool_read(void* handle, int64_t i, float* out) {
  Spool* s = static_cast<Spool*>(handle);
  fseek(s->f, s->offsets[i] + sizeof(double) + sizeof(int64_t), SEEK_SET);
  int64_t n = s->counts[i];
  if (n > 0 &&
      fread(out, sizeof(float), n * 3, s->f) != static_cast<size_t>(n * 3))
    return -1;
  return 0;
}

// ---------------------------------------------------- host voxel prefilter
// Optional host-side voxel thinning used by the IO path to bound transfer
// sizes before device upload (exact centroid semantics like ops.voxel).
int64_t pcio_voxel_thin(const float* xyz, int64_t n, float resolution,
                        float** out) {
  if (n <= 0) { *out = nullptr; return 0; }
  struct Cell { double sx, sy, sz; int64_t cnt; };
  // open addressing hash table
  size_t cap = 1;
  while (cap < static_cast<size_t>(n) * 2) cap <<= 1;
  std::vector<int64_t> keys(cap, INT64_MIN);
  std::vector<Cell> cells(cap);
  const double inv = 1.0 / resolution;
  size_t used = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t ix = static_cast<int64_t>(
        __builtin_floor(xyz[i * 3 + 0] * inv));
    int64_t iy = static_cast<int64_t>(
        __builtin_floor(xyz[i * 3 + 1] * inv));
    int64_t iz = static_cast<int64_t>(
        __builtin_floor(xyz[i * 3 + 2] * inv));
    int64_t key = (ix * 73856093LL) ^ (iy * 19349669LL) ^ (iz * 83492791LL);
    // combine exact coords into key to avoid collisions between cells:
    // store packed 21-bit signed coords
    int64_t packed = ((ix & 0x1FFFFF) << 42) | ((iy & 0x1FFFFF) << 21) |
                     (iz & 0x1FFFFF);
    size_t h = static_cast<size_t>(key) & (cap - 1);
    while (true) {
      if (keys[h] == INT64_MIN) {
        keys[h] = packed;
        cells[h] = {0, 0, 0, 0};
        used++;
        break;
      }
      if (keys[h] == packed) break;
      h = (h + 1) & (cap - 1);
    }
    cells[h].sx += xyz[i * 3 + 0];
    cells[h].sy += xyz[i * 3 + 1];
    cells[h].sz += xyz[i * 3 + 2];
    cells[h].cnt += 1;
  }
  float* dst = static_cast<float*>(malloc(used * 3 * sizeof(float)));
  if (!dst) return -1;
  size_t k = 0;
  for (size_t h = 0; h < cap; ++h) {
    if (keys[h] == INT64_MIN) continue;
    dst[k * 3 + 0] = static_cast<float>(cells[h].sx / cells[h].cnt);
    dst[k * 3 + 1] = static_cast<float>(cells[h].sy / cells[h].cnt);
    dst[k * 3 + 2] = static_cast<float>(cells[h].sz / cells[h].cnt);
    ++k;
  }
  *out = dst;
  return static_cast<int64_t>(k);
}

}  // extern "C"
