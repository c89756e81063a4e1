// Native runtime components for nbody_tpu.
//
// 1) CPU validation oracle (OpenMP all-pairs) — the same role as the
//    reference's validation.cpp CPU_compute / bodyInteractions_CPU
//    (validation.cpp:9-52): an independent native implementation of the
//    softened all-pairs force law and the fused half-kick+drift update,
//    used for differential testing of the device paths. Float and double
//    variants (the reference is float-only; double is the precision-upgrade
//    twin of the NumPy oracle).
//
// 2) PNG frame encoder — native back end of the headless visualization
//    stream (the role OpenGL/GLFW plays in the reference): RGB8 -> PNG via
//    zlib, callable from the Python FrameStreamer for high-rate export.
//
// Built as a shared library; loaded with ctypes (see
// nbody_tpu/oracle/native.py and nbody_tpu/viz/native_png.py).

#include <cmath>
#include <cstdint>
#include <cstring>

#include <zlib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Oracle
// ---------------------------------------------------------------------------

// Softened all-pairs accelerations with explicit i != j guard.
// pos: n*3, mass: n, acc out: n*3.
void nbody_forces_f32(const float* pos, const float* mass, int64_t n,
                      float eps2, float* acc) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (int64_t j = 0; j < n; ++j) {
      if (j == i) continue;
      const float dx = pos[3 * j] - xi;
      const float dy = pos[3 * j + 1] - yi;
      const float dz = pos[3 * j + 2] - zi;
      const float d2 = dx * dx + dy * dy + dz * dz + eps2;
      const float inv = 1.0f / std::sqrt(d2 * d2 * d2);
      const float f = mass[j] * inv;
      ax += f * dx;
      ay += f * dy;
      az += f * dz;
    }
    acc[3 * i] = ax;
    acc[3 * i + 1] = ay;
    acc[3 * i + 2] = az;
  }
}

void nbody_forces_f64(const double* pos, const double* mass, int64_t n,
                      double eps2, double* acc) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    double ax = 0., ay = 0., az = 0.;
    for (int64_t j = 0; j < n; ++j) {
      if (j == i) continue;
      const double dx = pos[3 * j] - xi;
      const double dy = pos[3 * j + 1] - yi;
      const double dz = pos[3 * j + 2] - zi;
      const double d2 = dx * dx + dy * dy + dz * dz + eps2;
      const double inv = 1.0 / std::sqrt(d2 * d2 * d2);
      const double f = mass[j] * inv;
      ax += f * dx;
      ay += f * dy;
      az += f * dz;
    }
    acc[3 * i] = ax;
    acc[3 * i + 1] = ay;
    acc[3 * i + 2] = az;
  }
}

// One full oracle step: forces from current positions, then the reference
// update v += 0.5*dt*a; x += dt*v (in-place, like CPU_compute).
void nbody_step_f32(float* pos, float* vel, float* acc, const float* mass,
                    int64_t n, float eps2, float dt) {
  nbody_forces_f32(pos, mass, n, eps2, acc);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    for (int c = 0; c < 3; ++c) {
      vel[3 * i + c] += 0.5f * dt * acc[3 * i + c];
      pos[3 * i + c] += dt * vel[3 * i + c];
    }
  }
}

void nbody_step_f64(double* pos, double* vel, double* acc, const double* mass,
                    int64_t n, double eps2, double dt) {
  nbody_forces_f64(pos, mass, n, eps2, acc);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    for (int c = 0; c < 3; ++c) {
      vel[3 * i + c] += 0.5 * dt * acc[3 * i + c];
      pos[3 * i + c] += dt * vel[3 * i + c];
    }
  }
}

// Multi-step lock-step run (keeps the whole loop native).
void nbody_run_f32(float* pos, float* vel, float* acc, const float* mass,
                   int64_t n, float eps2, float dt, int64_t steps) {
  for (int64_t s = 0; s < steps; ++s) {
    nbody_step_f32(pos, vel, acc, mass, n, eps2, dt);
  }
}

void nbody_run_f64(double* pos, double* vel, double* acc, const double* mass,
                   int64_t n, double eps2, double dt, int64_t steps) {
  for (int64_t s = 0; s < steps; ++s) {
    nbody_step_f64(pos, vel, acc, mass, n, eps2, dt);
  }
}

// Kick-drift-kick leapfrog runs (the KDK twin of ops/step.py's kdk path;
// acc must hold a(x_0) on entry — pass a zero buffer and the priming force
// evaluation is done here).
void nbody_run_kdk_f32(float* pos, float* vel, float* acc, const float* mass,
                       int64_t n, float eps2, float dt, int64_t steps) {
  nbody_forces_f32(pos, mass, n, eps2, acc);
  for (int64_t s = 0; s < steps; ++s) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < 3 * n; ++i) {
      vel[i] += 0.5f * dt * acc[i];   // half kick with a(x_n)
      pos[i] += dt * vel[i];          // drift
    }
    nbody_forces_f32(pos, mass, n, eps2, acc);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < 3 * n; ++i) {
      vel[i] += 0.5f * dt * acc[i];   // half kick with a(x_{n+1})
    }
  }
}

void nbody_run_kdk_f64(double* pos, double* vel, double* acc,
                       const double* mass, int64_t n, double eps2, double dt,
                       int64_t steps) {
  nbody_forces_f64(pos, mass, n, eps2, acc);
  for (int64_t s = 0; s < steps; ++s) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < 3 * n; ++i) {
      vel[i] += 0.5 * dt * acc[i];
      pos[i] += dt * vel[i];
    }
    nbody_forces_f64(pos, mass, n, eps2, acc);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < 3 * n; ++i) {
      vel[i] += 0.5 * dt * acc[i];
    }
  }
}

int nbody_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// ---------------------------------------------------------------------------
// PNG encoder
// ---------------------------------------------------------------------------

static void put_u32be(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)(v >> 24);
  p[1] = (uint8_t)(v >> 16);
  p[2] = (uint8_t)(v >> 8);
  p[3] = (uint8_t)v;
}

static size_t write_chunk(uint8_t* out, const char tag[4], const uint8_t* data,
                          size_t len) {
  put_u32be(out, (uint32_t)len);
  std::memcpy(out + 4, tag, 4);
  if (len) std::memcpy(out + 8, data, len);
  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, out + 4, (uInt)(4 + len));
  put_u32be(out + 8 + len, crc);
  return 12 + len;
}

// Encode (h, w, 3) RGB8 into PNG. Returns bytes written, or -1 if out_cap
// too small, -2 on zlib error. out_cap should be >= png_max_size(w, h).
int64_t png_encode_rgb(const uint8_t* rgb, int32_t w, int32_t h,
                       int32_t compress_level, uint8_t* out, int64_t out_cap) {
  const size_t stride = (size_t)w * 3;
  const size_t raw_len = (size_t)h * (stride + 1);
  uint8_t* raw = new uint8_t[raw_len];
  for (int32_t y = 0; y < h; ++y) {
    raw[y * (stride + 1)] = 0;  // filter: None
    std::memcpy(raw + y * (stride + 1) + 1, rgb + y * stride, stride);
  }
  uLongf comp_cap = compressBound((uLong)raw_len);
  uint8_t* comp = new uint8_t[comp_cap];
  int rc = compress2(comp, &comp_cap, raw, (uLong)raw_len,
                     compress_level < 0 ? 6 : compress_level);
  delete[] raw;
  if (rc != Z_OK) {
    delete[] comp;
    return -2;
  }
  const int64_t need = 8 + 25 + (12 + (int64_t)comp_cap) + 12;
  if (out_cap < need) {
    delete[] comp;
    return -1;
  }
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  std::memcpy(out, sig, 8);
  size_t off = 8;
  uint8_t ihdr[13];
  put_u32be(ihdr, (uint32_t)w);
  put_u32be(ihdr + 4, (uint32_t)h);
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  off += write_chunk(out + off, "IHDR", ihdr, 13);
  off += write_chunk(out + off, "IDAT", comp, comp_cap);
  off += write_chunk(out + off, "IEND", nullptr, 0);
  delete[] comp;
  return (int64_t)off;
}

int64_t png_max_size(int32_t w, int32_t h) {
  const size_t raw_len = (size_t)h * ((size_t)w * 3 + 1);
  return 8 + 25 + 12 + (int64_t)compressBound((uLong)raw_len) + 12 + 64;
}

}  // extern "C"
