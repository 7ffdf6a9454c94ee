// Native I/O runtime for lbm_tpu.
//
// The reference does all of its scene parsing and result dumping with C stdio
// (SerialCode/d2q9-bgk.c:460-613 for input, 662-743 for output).  This library
// is this framework's native equivalent: a buffered obstacle parser and
// %.12E-formatted writers for final_state.dat / av_vels.dat, bound from
// Python via ctypes (lbm_tpu/io/native.py).  Formatting matches the reference
// byte-for-byte because both use printf %.12E.
//
// Error contract (negative return codes mirror the reference's die() cases):
//   -1 cannot open file     -2 malformed line       -3 x out of range
//   -4 y out of range       -5 blocked flag != 1    -6 write failure

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <string>
#include <vector>

extern "C" {

int lbmio_load_obstacles(const char* path, int nx, int ny, uint8_t* mask) {
  FILE* fp = std::fopen(path, "r");
  if (!fp) return -1;

  // Read the whole file and parse with a simple integer scanner; obstacle
  // files are lists of "x y 1" triples.
  std::fseek(fp, 0, SEEK_END);
  long size = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::string buf;
  buf.resize(static_cast<size_t>(size));
  size_t got = std::fread(buf.data(), 1, buf.size(), fp);
  std::fclose(fp);
  buf.resize(got);

  const char* p = buf.data();
  const char* end = p + buf.size();
  while (p < end) {
    // Skip whitespace/newlines between triples.
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;

    long vals[3];
    for (int i = 0; i < 3; ++i) {
      if (i > 0) {
        const char* q = p;
        while (p < end && (*p == ' ' || *p == '\t')) ++p;
        if (p == q || p >= end || *p == '\n') return -2;
      }
      bool neg = false;
      if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
      if (p >= end || *p < '0' || *p > '9') return -2;
      long v = 0;
      while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
      vals[i] = neg ? -v : v;
    }
    // Nothing but whitespace may follow on the line.
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    if (p < end && *p != '\n') return -2;

    if (vals[0] < 0 || vals[0] >= nx) return -3;
    if (vals[1] < 0 || vals[1] >= ny) return -4;
    if (vals[2] != 1) return -5;
    mask[vals[1] * static_cast<long>(nx) + vals[0]] = 1;
  }
  return 0;
}

int lbmio_write_final_state(const char* path, const float* u_x, const float* u_y,
                            const float* u, const float* pressure,
                            const uint8_t* obstacles, int ny, int nx) {
  FILE* fp = std::fopen(path, "w");
  if (!fp) return -1;
  // Large stdio buffer: the 1024x1024 grid emits ~80 MB of text.
  std::vector<char> iobuf(1 << 20);
  std::setvbuf(fp, iobuf.data(), _IOFBF, iobuf.size());

  for (int jj = 0; jj < ny; ++jj) {
    const long row = static_cast<long>(jj) * nx;
    for (int ii = 0; ii < nx; ++ii) {
      const long idx = row + ii;
      if (std::fprintf(fp, "%d %d %.12E %.12E %.12E %.12E %d\n", ii, jj,
                       static_cast<double>(u_x[idx]), static_cast<double>(u_y[idx]),
                       static_cast<double>(u[idx]), static_cast<double>(pressure[idx]),
                       static_cast<int>(obstacles[idx])) < 0) {
        std::fclose(fp);
        return -6;
      }
    }
  }
  if (std::fclose(fp) != 0) return -6;
  return 0;
}

int lbmio_write_av_vels(const char* path, const float* av_vels, long n) {
  FILE* fp = std::fopen(path, "w");
  if (!fp) return -1;
  std::vector<char> iobuf(1 << 20);
  std::setvbuf(fp, iobuf.data(), _IOFBF, iobuf.size());
  for (long tt = 0; tt < n; ++tt) {
    if (std::fprintf(fp, "%ld:\t%.12E\n", tt, static_cast<double>(av_vels[tt])) < 0) {
      std::fclose(fp);
      return -6;
    }
  }
  if (std::fclose(fp) != 0) return -6;
  return 0;
}

}  // extern "C"
