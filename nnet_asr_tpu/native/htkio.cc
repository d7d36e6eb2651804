// Native HTK feature-file I/O for the input pipeline hot path.
//
// Counterpart of the reference's KaldiLib feature reading
// (Features.cc:1011-1279): where the reference fseek()s per frame, this
// reads the file once, byte-swaps/decompresses with tight loops, applies
// the frame-range + edge-extension logic, and returns float32 frames ready
// for device upload. Exposed through a plain C ABI consumed via ctypes
// (io/native.py); calls release the GIL so a Python thread pool gets real
// parallel file reading (the Platform reader-thread analog, Platform.h:201-245).
//
// Build: g++ -O2 -shared -fPIC -o libhtkio.so htkio.cc

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

const uint16_t PARMKIND_C = 02000;

inline uint32_t bswap32(uint32_t v) {
  return (v >> 24) | ((v >> 8) & 0xff00) | ((v << 8) & 0xff0000) | (v << 24);
}
inline uint16_t bswap16(uint16_t v) { return (uint16_t)((v >> 8) | (v << 8)); }

inline bool host_is_little() {
  const uint16_t one = 1;
  return *(const uint8_t*)&one == 1;
}

struct Header {
  int32_t n_samples;
  int32_t sample_period;
  int16_t sample_size;
  uint16_t sample_kind;
};

// read and (if needed) swap the 12-byte header
int read_header(FILE* f, int big_endian, Header* h) {
  uint8_t buf[12];
  if (fread(buf, 1, 12, f) != 12) return -1;
  memcpy(&h->n_samples, buf, 4);
  memcpy(&h->sample_period, buf + 4, 4);
  memcpy(&h->sample_size, buf + 8, 2);
  memcpy(&h->sample_kind, buf + 10, 2);
  const bool swap = big_endian == (host_is_little() ? 1 : 0);
  if (swap) {
    h->n_samples = (int32_t)bswap32((uint32_t)h->n_samples);
    h->sample_period = (int32_t)bswap32((uint32_t)h->sample_period);
    h->sample_size = (int16_t)bswap16((uint16_t)h->sample_size);
    h->sample_kind = bswap16(h->sample_kind);
  }
  if (h->sample_period < 0 || h->sample_period > 100000 || h->n_samples < 0 ||
      h->sample_size < 0)
    return -1;
  return 0;
}

}  // namespace

extern "C" {

// Parse header only. Returns 0 on success.
int htk_read_header(const char* path, int big_endian, int32_t* n_samples,
                    int32_t* sample_period, int32_t* sample_size,
                    int32_t* sample_kind) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  int rc = read_header(f, big_endian, &h);
  fclose(f);
  if (rc) return rc;
  // report the decompressed view (C bit cleared, A/B rows removed)
  if (h.sample_kind & PARMKIND_C) {
    *n_samples = h.n_samples - 4;
    *sample_size = (h.sample_size / 2) * 4;
    *sample_kind = h.sample_kind & ~PARMKIND_C;
  } else {
    *n_samples = h.n_samples;
    *sample_size = h.sample_size;
    *sample_kind = h.sample_kind;
  }
  *sample_period = h.sample_period;
  return 0;
}

// Read frames [from, to] (inclusive; pass from=0 to=-1 for all) with
// start/end edge extension. `out` must hold
// (to-from+1+ext_head+ext_tail) * dim floats, where the caller obtains
// dim from htk_read_header (sample_size/4). Extension first consumes real
// frames outside the range, then replicates edges (Features.cc:1185-1199).
// Returns the number of frames written, or -1 on error.
int htk_read_frames(const char* path, int big_endian, int from, int to,
                    int start_ext, int end_ext, float* out, int64_t capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  if (read_header(f, big_endian, &h)) {
    fclose(f);
    return -1;
  }
  const bool swap = big_endian == (host_is_little() ? 1 : 0);
  const bool comp = (h.sample_kind & PARMKIND_C) != 0;
  const int dim = comp ? h.sample_size / 2 : h.sample_size / 4;
  const int n_avail = comp ? h.n_samples - 4 : h.n_samples;
  if (dim <= 0 || n_avail <= 0) {
    fclose(f);
    return -1;
  }

  float* A = nullptr;
  float* B = nullptr;
  if (comp) {
    A = (float*)malloc(sizeof(float) * dim * 2);
    B = A + dim;
    if (fread(A, 4, (size_t)dim * 2, f) != (size_t)dim * 2) {
      free(A);
      fclose(f);
      return -1;
    }
    if (swap) {
      uint32_t* p = (uint32_t*)A;
      for (int i = 0; i < dim * 2; i++) p[i] = bswap32(p[i]);
    }
  }

  if (to < 0) to = n_avail - 1;
  // extension consumes real frames outside the range first
  int ext_l = start_ext, ext_r = end_ext;
  int take = from < ext_l ? from : ext_l;
  from -= take;
  ext_l -= take;
  int avail_r = n_avail - to - 1;
  take = avail_r < ext_r ? avail_r : ext_r;
  to += take;
  ext_r -= take;
  if (from > to || from >= n_avail || to < 0) {
    free(A);
    fclose(f);
    return -1;
  }
  const int n_read = to - from + 1;
  const int total = n_read + ext_l + ext_r;
  if ((int64_t)total * dim > capacity) {
    free(A);
    fclose(f);
    return -1;
  }

  const long data_off = 12 + (comp ? 8L * dim : 0);
  const int coef_size = comp ? 2 : 4;
  if (fseek(f, data_off + (long)from * dim * coef_size, SEEK_SET)) {
    free(A);
    fclose(f);
    return -1;
  }

  float* dst = out + (int64_t)ext_l * dim;
  if (comp) {
    int16_t* raw = (int16_t*)malloc((size_t)n_read * dim * 2);
    if (fread(raw, 2, (size_t)n_read * dim, f) != (size_t)n_read * dim) {
      free(raw);
      free(A);
      fclose(f);
      return -1;
    }
    for (int64_t i = 0; i < (int64_t)n_read * dim; i++) {
      int16_t s = raw[i];
      if (swap) s = (int16_t)bswap16((uint16_t)s);
      int c = (int)(i % dim);
      dst[i] = ((float)s + B[c]) / A[c];
    }
    free(raw);
  } else {
    if (fread(dst, 4, (size_t)n_read * dim, f) != (size_t)n_read * dim) {
      free(A);
      fclose(f);
      return -1;
    }
    if (swap) {
      uint32_t* p = (uint32_t*)dst;
      for (int64_t i = 0; i < (int64_t)n_read * dim; i++) p[i] = bswap32(p[i]);
    }
  }
  fclose(f);
  free(A);

  // edge replication
  for (int i = 0; i < ext_l; i++)
    memcpy(out + (int64_t)i * dim, dst, sizeof(float) * dim);
  const float* last = out + (int64_t)(ext_l + n_read - 1) * dim;
  for (int i = 0; i < ext_r; i++)
    memcpy(out + (int64_t)(ext_l + n_read + i) * dim, last,
           sizeof(float) * dim);
  return total;
}

// Write an uncompressed float32 HTK file. Returns 0 on success.
int htk_write_file(const char* path, int big_endian, const float* data,
                   int n_frames, int dim, int sample_period, int sample_kind) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  Header h;
  h.n_samples = n_frames;
  h.sample_period = sample_period;
  h.sample_size = (int16_t)(dim * 4);
  h.sample_kind = (uint16_t)sample_kind;
  const bool swap = big_endian == (host_is_little() ? 1 : 0);
  Header w = h;
  if (swap) {
    w.n_samples = (int32_t)bswap32((uint32_t)h.n_samples);
    w.sample_period = (int32_t)bswap32((uint32_t)h.sample_period);
    w.sample_size = (int16_t)bswap16((uint16_t)h.sample_size);
    w.sample_kind = bswap16(h.sample_kind);
  }
  fwrite(&w.n_samples, 4, 1, f);
  fwrite(&w.sample_period, 4, 1, f);
  fwrite(&w.sample_size, 2, 1, f);
  fwrite(&w.sample_kind, 2, 1, f);
  if (swap) {
    uint32_t* tmp = (uint32_t*)malloc((size_t)n_frames * dim * 4);
    memcpy(tmp, data, (size_t)n_frames * dim * 4);
    for (int64_t i = 0; i < (int64_t)n_frames * dim; i++)
      tmp[i] = bswap32(tmp[i]);
    fwrite(tmp, 4, (size_t)n_frames * dim, f);
    free(tmp);
  } else {
    fwrite(data, 4, (size_t)n_frames * dim, f);
  }
  fclose(f);
  return 0;
}

}  // extern "C"
