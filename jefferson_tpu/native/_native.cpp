// jefferson_tpu native runtime: C++ host-side components.
//
// The reference's host runtime is native C++ throughout (libsndfile I/O,
// pinned-buffer block feeding, overlap-save memmove — reference:
// Jefferson/src/Audio.cu:119-157, Jefferson/src/cudaPart.cu:21-63).  This
// module is the rebuild's native equivalent for the host-side hot paths:
//
//   decode_wav(bytes)                 -> (float32 array [frames, ch], rate)
//   encode_pcm(float32 array, bits)   -> bytes (PCM 16/24/32, interleaved)
//   fed_stream(signal, blocks, fpb)   -> wrapped playhead stream
//   build_segments(stream, hist, fpb, pad) -> overlap-save windows [B, pad]
//
// Built with scripts/build_native.py (plain g++, CPython + NumPy C API —
// no pybind11 in this environment).  jefferson_tpu.native falls back to the
// pure-NumPy implementations when this extension is absent.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct FmtInfo {
  uint16_t tag = 0;
  uint16_t channels = 0;
  uint32_t rate = 0;
  uint16_t bits = 0;
};

bool read_u32(const uint8_t* d, size_t len, size_t off, uint32_t* out) {
  if (off + 4 > len) return false;
  std::memcpy(out, d + off, 4);
  return true;
}

// Parse RIFF/WAVE, locate fmt + data chunks. Returns false on malformed input.
bool parse_wav(const uint8_t* d, size_t len, FmtInfo* fmt, size_t* data_off,
               size_t* data_len) {
  if (len < 12 || std::memcmp(d, "RIFF", 4) || std::memcmp(d + 8, "WAVE", 4))
    return false;
  size_t pos = 12;
  bool have_fmt = false, have_data = false;
  while (pos + 8 <= len) {
    uint32_t size;
    if (!read_u32(d, len, pos + 4, &size)) return false;
    const uint8_t* id = d + pos;
    size_t body = pos + 8;
    size_t body_end = body + size;
    if (body_end > len) body_end = len;
    if (!have_fmt && !std::memcmp(id, "fmt ", 4) && body_end - body >= 16) {
      std::memcpy(&fmt->tag, d + body, 2);
      std::memcpy(&fmt->channels, d + body + 2, 2);
      std::memcpy(&fmt->rate, d + body + 4, 4);
      std::memcpy(&fmt->bits, d + body + 14, 2);
      if (fmt->tag == 0xFFFE && body_end - body >= 26)
        std::memcpy(&fmt->tag, d + body + 24, 2);  // EXTENSIBLE SubFormat
      have_fmt = true;
    } else if (!have_data && !std::memcmp(id, "data", 4)) {
      *data_off = body;
      *data_len = body_end - body;
      have_data = true;
    }
    pos = body + size + (size & 1);
  }
  return have_fmt && have_data;
}

PyObject* decode_wav(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  const uint8_t* d = static_cast<const uint8_t*>(buf.buf);
  size_t len = buf.len;
  FmtInfo fmt;
  size_t off = 0, dlen = 0;
  if (!parse_wav(d, len, &fmt, &off, &dlen)) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "malformed WAV (missing fmt/data)");
    return nullptr;
  }
  if (fmt.channels == 0) {
    // match the Python parser: channels=0 is malformed, not mono
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "malformed fmt chunk (channels=0)");
    return nullptr;
  }
  const int ch = fmt.channels;
  const size_t bytes_per = fmt.bits / 8;
  if (bytes_per == 0) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "zero bit depth");
    return nullptr;
  }
  const size_t frames = dlen / (bytes_per * ch);
  npy_intp dims[2] = {static_cast<npy_intp>(frames), ch};
  PyObject* arr = PyArray_SimpleNew(2, dims, NPY_FLOAT32);
  if (!arr) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  float* out = static_cast<float*>(PyArray_DATA(reinterpret_cast<PyArrayObject*>(arr)));
  const uint8_t* p = d + off;
  const size_t n = frames * ch;
  bool ok = true;
  if (fmt.tag == 3 && fmt.bits == 32) {
    std::memcpy(out, p, n * 4);
  } else if (fmt.tag == 3 && fmt.bits == 64) {
    const double* s = reinterpret_cast<const double*>(p);
    for (size_t i = 0; i < n; i++) out[i] = static_cast<float>(s[i]);
  } else if (fmt.tag == 1 && fmt.bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(p);
    const float k = 1.0f / 32768.0f;
    for (size_t i = 0; i < n; i++) out[i] = s[i] * k;
  } else if (fmt.tag == 1 && fmt.bits == 24) {
    const double k = 1.0 / 8388608.0;
    for (size_t i = 0; i < n; i++) {
      int32_t v = p[3 * i] | (p[3 * i + 1] << 8) | (p[3 * i + 2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      out[i] = static_cast<float>(v * k);
    }
  } else if (fmt.tag == 1 && fmt.bits == 32) {
    const int32_t* s = reinterpret_cast<const int32_t*>(p);
    const double k = 1.0 / 2147483648.0;
    for (size_t i = 0; i < n; i++) out[i] = static_cast<float>(s[i] * k);
  } else if (fmt.tag == 1 && fmt.bits == 8) {
    const float k = 1.0f / 128.0f;
    for (size_t i = 0; i < n; i++) out[i] = (static_cast<int>(p[i]) - 128) * k;
  } else {
    ok = false;
  }
  PyBuffer_Release(&buf);
  if (!ok) {
    Py_DECREF(arr);
    PyErr_Format(PyExc_ValueError, "unsupported WAV format tag=%d bits=%d",
                 fmt.tag, fmt.bits);
    return nullptr;
  }
  return Py_BuildValue("(Ni)", arr, static_cast<int>(fmt.rate));
}

PyObject* encode_pcm(PyObject*, PyObject* args) {
  PyObject* in;
  int bits;
  if (!PyArg_ParseTuple(args, "Oi", &in, &bits)) return nullptr;
  PyArrayObject* arr = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(in, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED));
  if (!arr) return nullptr;
  const size_t n = static_cast<size_t>(PyArray_SIZE(arr));
  const float* x = static_cast<const float*>(PyArray_DATA(arr));
  const double scale = static_cast<double>(1LL << (bits - 1));
  const double lo = -scale, hi = scale - 1;
  PyObject* bytes = PyBytes_FromStringAndSize(nullptr, n * (bits / 8));
  if (!bytes) {
    Py_DECREF(arr);
    return nullptr;
  }
  uint8_t* o = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(bytes));
  auto quant = [&](size_t i) -> int64_t {
    double v = static_cast<double>(x[i]) * scale;
    v = v < lo ? lo : (v > hi ? hi : v);
    // round half away from zero like np.rint? np.rint is half-to-even; match it
    double r = std::nearbyint(v);
    return static_cast<int64_t>(r);
  };
  if (bits == 16) {
    int16_t* s = reinterpret_cast<int16_t*>(o);
    for (size_t i = 0; i < n; i++) s[i] = static_cast<int16_t>(quant(i));
  } else if (bits == 24) {
    for (size_t i = 0; i < n; i++) {
      int32_t v = static_cast<int32_t>(quant(i));
      o[3 * i] = v & 0xFF;
      o[3 * i + 1] = (v >> 8) & 0xFF;
      o[3 * i + 2] = (v >> 16) & 0xFF;
    }
  } else if (bits == 32) {
    int32_t* s = reinterpret_cast<int32_t*>(o);
    for (size_t i = 0; i < n; i++) s[i] = static_cast<int32_t>(quant(i));
  } else {
    Py_DECREF(arr);
    Py_DECREF(bytes);
    PyErr_SetString(PyExc_ValueError, "bits must be 16, 24 or 32");
    return nullptr;
  }
  Py_DECREF(arr);
  return bytes;
}

// fed_stream(signal float32[n], num_blocks, fpb) -> float32[num_blocks*fpb]
// Wrapping playhead (reference: Jefferson/src/Audio.cu:121-139).
PyObject* fed_stream(PyObject*, PyObject* args) {
  PyObject* in;
  long num_blocks, fpb;
  if (!PyArg_ParseTuple(args, "Oll", &in, &num_blocks, &fpb)) return nullptr;
  PyArrayObject* arr = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(in, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED));
  if (!arr) return nullptr;
  const size_t n = static_cast<size_t>(PyArray_SIZE(arr));
  if (n == 0) {
    Py_DECREF(arr);
    PyErr_SetString(PyExc_ValueError, "empty signal");
    return nullptr;
  }
  const float* x = static_cast<const float*>(PyArray_DATA(arr));
  npy_intp total = num_blocks * fpb;
  npy_intp dims[1] = {total};
  PyObject* outo = PyArray_SimpleNew(1, dims, NPY_FLOAT32);
  float* o = static_cast<float*>(PyArray_DATA(reinterpret_cast<PyArrayObject*>(outo)));
  size_t pos = 0;
  npy_intp i = 0;
  while (i < total) {
    size_t chunk = n - pos;
    if (static_cast<npy_intp>(chunk) > total - i) chunk = total - i;
    std::memcpy(o + i, x + pos, chunk * sizeof(float));
    i += chunk;
    pos += chunk;
    if (pos == n) pos = 0;
  }
  Py_DECREF(arr);
  return outo;
}

// build_segments(stream float32[B*fpb], hist float32[pad-fpb], fpb, pad)
//   -> float32[B, pad] overlap-save windows
PyObject* build_segments(PyObject*, PyObject* args) {
  PyObject *in, *hin;
  long fpb, pad;
  if (!PyArg_ParseTuple(args, "OOll", &in, &hin, &fpb, &pad)) return nullptr;
  PyArrayObject* arr = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(in, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED));
  PyArrayObject* harr = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(hin, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED));
  if (!arr || !harr) {
    Py_XDECREF(arr);
    Py_XDECREF(harr);
    return nullptr;
  }
  const long hist = pad - fpb;
  if (PyArray_SIZE(harr) != hist || PyArray_SIZE(arr) % fpb) {
    Py_DECREF(arr);
    Py_DECREF(harr);
    PyErr_SetString(PyExc_ValueError, "bad stream/history sizes");
    return nullptr;
  }
  const long b = PyArray_SIZE(arr) / fpb;
  const float* x = static_cast<const float*>(PyArray_DATA(arr));
  const float* h = static_cast<const float*>(PyArray_DATA(harr));
  // concatenated view: [hist | stream]
  std::vector<float> full(hist + b * fpb);
  std::memcpy(full.data(), h, hist * sizeof(float));
  std::memcpy(full.data() + hist, x, b * fpb * sizeof(float));
  npy_intp dims[2] = {b, pad};
  PyObject* outo = PyArray_SimpleNew(2, dims, NPY_FLOAT32);
  float* o = static_cast<float*>(PyArray_DATA(reinterpret_cast<PyArrayObject*>(outo)));
  for (long i = 0; i < b; i++)
    std::memcpy(o + i * pad, full.data() + i * fpb, pad * sizeof(float));
  Py_DECREF(arr);
  Py_DECREF(harr);
  return outo;
}

// ---------------------------------------------------------------------------
// Host plan core: the reference's spatial-state math in its native language.
//
// Exact C++ ports of SoundSource::interpolationCalculations (reference:
// Jefferson/src/SoundSource.cu:65-105), pick_hrtf (reference:
// Jefferson/src/hrtf_signals.cu:20-51), the 4-case weight chains (reference:
// Jefferson/src/CPUSoundSource.cpp:174-242,255-273), and the engine's
// float64 distance phase split (ops/filters.distance_phase_split).  Every
// operation is float32/trunc-exact, matching the NumPy implementations BIT
// FOR BIT (asserted in tests/test_native.py) — the quirky C semantics
// (truncation toward zero at each int cast, non-normalized omegas) are the
// reference's own, expressed in the reference's own language.

const int kNumElev = 14;
const int kElev[kNumElev] = {-40, -30, -20, -10, 0, 10, 20, 30, 40, 50, 60, 70, 80, 90};
const float kAzIncr[kNumElev] = {6.43f, 6.00f, 5.00f, 5.00f, 5.00f, 5.00f, 5.00f,
                                 6.00f, 6.43f, 8.00f, 10.00f, 15.00f, 30.00f, 361.0f};
// azimuth counts per row (reference: Jefferson/src/hrtf_signals.cu:7-11)
const int kAzCount[kNumElev] = {56, 60, 72, 72, 72, 72, 72, 60, 56, 45, 36, 24, 12, 1};

int az_offset(int row) {
  int off = 0;
  for (int i = 0; i < row; i++) off += kAzCount[i];
  return off;
}

float round_half_away_f(float x) {
  // std::round IS half-away-from-zero — the reference's own round()
  // (SoundSource.cu) — and is exact; the former floor(|x|+0.5f) trick
  // misrounded f32 inputs within an ulp below a .5 boundary (the +0.5f
  // itself rounded up to the tie).  Kept bit-exact with the NumPy
  // round_half_away (hrtf/kemar.py).
  return std::round(x);
}

// pick_hrtf(ele, azi) — first-minimum linear scans, float32 arithmetic
// (reference: Jefferson/src/hrtf_signals.cu:20-51)
int32_t pick_hrtf_one(float ele, float azi) {
  float ele_snap = round_half_away_f(ele / 10.0f) * 10.0f;
  int row = 0;
  float best = std::fabs(ele_snap - static_cast<float>(kElev[0]));
  for (int i = 1; i < kNumElev; i++) {
    float d = std::fabs(ele_snap - static_cast<float>(kElev[i]));
    if (d < best) {
      best = d;
      row = i;
    }
  }
  float azi_r = round_half_away_f(azi);
  float inc = kAzIncr[row];
  int best_i = 0;
  float bd = std::fabs(azi_r - 0.0f * inc);
  for (int i = 1; i < kAzCount[row]; i++) {
    float d = std::fabs(azi_r - static_cast<float>(i) * inc);
    if (d < bd) {
      bd = d;
      best_i = i;
    }
  }
  return static_cast<int32_t>(az_offset(row) + best_i);
}

int row_of_phi(int phi) {
  int p = phi < kElev[0] ? kElev[0] : (phi > kElev[kNumElev - 1] ? kElev[kNumElev - 1] : phi);
  return (p - kElev[0]) / 10;
}

// interpolationCalculations for one position; writes 4 indices, 4 effective
// case weights, 6 omegas, and the case id.
void interp_one(float ele, float azi, int32_t* idx, float* w, float* omegas,
                int8_t* case_out) {
  int ele_i = static_cast<int>(ele);              // C trunc toward zero
  int phi0 = ele_i / 10 * 10;                     // C integer division
  int e9 = static_cast<int>(ele + 9.0f);
  int phi1 = e9 / 10 * 10;
  float omega_e = (ele - static_cast<float>(phi0)) / 10.0f;
  float omega_f = (static_cast<float>(phi1) - ele) / 10.0f;

  float dt1 = kAzIncr[row_of_phi(phi0)];
  float dt2 = kAzIncr[row_of_phi(phi1)];

  auto theta_lo = [&](float dt) {
    return static_cast<int>(static_cast<float>(static_cast<int>(azi / dt)) * dt);
  };
  auto theta_hi = [&](float dt) {
    return static_cast<int>(
        static_cast<float>(static_cast<int>((azi + dt - 1.0f) / dt)) * dt);
  };
  int theta0 = theta_lo(dt1), theta1 = theta_hi(dt1);
  int theta2 = theta_lo(dt2), theta3 = theta_hi(dt2);

  float omega_a = (azi - static_cast<float>(theta0)) / dt1;
  float omega_b = (static_cast<float>(theta1) - azi) / dt1;
  float omega_c = (azi - static_cast<float>(theta2)) / dt2;
  float omega_d = (static_cast<float>(theta3) - azi) / dt2;

  idx[0] = pick_hrtf_one(static_cast<float>(phi0), static_cast<float>(theta0));
  idx[1] = pick_hrtf_one(static_cast<float>(phi0), static_cast<float>(theta1));
  idx[2] = pick_hrtf_one(static_cast<float>(phi1), static_cast<float>(theta2));
  idx[3] = pick_hrtf_one(static_cast<float>(phi1), static_cast<float>(theta3));

  omegas[0] = omega_a; omegas[1] = omega_b; omegas[2] = omega_c;
  omegas[3] = omega_d; omegas[4] = omega_e; omegas[5] = omega_f;

  // case dispatch (reference: Jefferson/src/CPUSoundSource.cpp:258-272)
  int8_t c;
  if (idx[0] == idx[1] && idx[1] == idx[2] && idx[2] == idx[3]) c = 1;
  else if (idx[0] == idx[2]) c = 2;
  else if (idx[0] == idx[1]) c = 3;
  else c = 4;
  *case_out = c;
  switch (c) {
    case 1: w[0] = 1.0f; w[1] = 0.0f; w[2] = 0.0f; w[3] = 0.0f; break;
    case 2: w[0] = omega_b; w[1] = omega_a; w[2] = 0.0f; w[3] = 0.0f; break;
    case 3: w[0] = omega_f; w[1] = 0.0f; w[2] = omega_e; w[3] = 0.0f; break;
    default:
      w[0] = omega_f * omega_b;
      w[1] = omega_f * omega_a;
      w[2] = omega_e * omega_d;
      w[3] = omega_e * omega_c;
  }
}

// pick_hrtf(ele float32[b], azi float32[b]) -> int32[b]
PyObject* pick_hrtf(PyObject*, PyObject* args) {
  PyObject *ein, *ain;
  if (!PyArg_ParseTuple(args, "OO", &ein, &ain)) return nullptr;
  PyArrayObject* ea = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(ein, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED));
  PyArrayObject* aa = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(ain, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED));
  if (!ea || !aa || PyArray_SIZE(ea) != PyArray_SIZE(aa)) {
    Py_XDECREF(ea);
    Py_XDECREF(aa);
    if (!PyErr_Occurred()) PyErr_SetString(PyExc_ValueError, "size mismatch");
    return nullptr;
  }
  const npy_intp b = PyArray_SIZE(ea);
  const float* e = static_cast<const float*>(PyArray_DATA(ea));
  const float* a = static_cast<const float*>(PyArray_DATA(aa));
  npy_intp dims[1] = {b};
  PyObject* outo = PyArray_SimpleNew(1, dims, NPY_INT32);
  int32_t* o = static_cast<int32_t*>(PyArray_DATA(reinterpret_cast<PyArrayObject*>(outo)));
  for (npy_intp i = 0; i < b; i++) o[i] = pick_hrtf_one(e[i], a[i]);
  Py_DECREF(ea);
  Py_DECREF(aa);
  return outo;
}

// interp_plan(ele float32[b], azi float32[b])
//   -> (idx int32[b,4], w float32[b,4], omegas float32[b,6], case int8[b])
PyObject* interp_plan(PyObject*, PyObject* args) {
  PyObject *ein, *ain;
  if (!PyArg_ParseTuple(args, "OO", &ein, &ain)) return nullptr;
  PyArrayObject* ea = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(ein, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED));
  PyArrayObject* aa = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(ain, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED));
  if (!ea || !aa || PyArray_SIZE(ea) != PyArray_SIZE(aa)) {
    Py_XDECREF(ea);
    Py_XDECREF(aa);
    if (!PyErr_Occurred()) PyErr_SetString(PyExc_ValueError, "size mismatch");
    return nullptr;
  }
  const npy_intp b = PyArray_SIZE(ea);
  const float* e = static_cast<const float*>(PyArray_DATA(ea));
  const float* a = static_cast<const float*>(PyArray_DATA(aa));
  npy_intp d2[2] = {b, 4}, d6[2] = {b, 6}, d1[1] = {b};
  PyObject* idxo = PyArray_SimpleNew(2, d2, NPY_INT32);
  PyObject* wo = PyArray_SimpleNew(2, d2, NPY_FLOAT32);
  PyObject* omo = PyArray_SimpleNew(2, d6, NPY_FLOAT32);
  PyObject* co = PyArray_SimpleNew(1, d1, NPY_INT8);
  int32_t* idx = static_cast<int32_t*>(PyArray_DATA(reinterpret_cast<PyArrayObject*>(idxo)));
  float* w = static_cast<float*>(PyArray_DATA(reinterpret_cast<PyArrayObject*>(wo)));
  float* om = static_cast<float*>(PyArray_DATA(reinterpret_cast<PyArrayObject*>(omo)));
  int8_t* c = static_cast<int8_t*>(PyArray_DATA(reinterpret_cast<PyArrayObject*>(co)));
  for (npy_intp i = 0; i < b; i++)
    interp_one(e[i], a[i], idx + 4 * i, w + 4 * i, om + 6 * i, c + i);
  Py_DECREF(ea);
  Py_DECREF(aa);
  return Py_BuildValue("(NNNN)", idxo, wo, omo, co);
}

// distance_phase_split(fsvs double, radii float32[b], num_bins)
//   -> (u_hi float32[b], u_lo float32[b], inv_frac float32[b])
// Exact port of ops/filters.distance_phase_split (12-bit head split; the
// head product with any k < 4096 is exact in fp32).
PyObject* distance_phase_split(PyObject*, PyObject* args) {
  double fsvs;
  PyObject* rin;
  long num_bins;
  if (!PyArg_ParseTuple(args, "dOl", &fsvs, &rin, &num_bins)) return nullptr;
  PyArrayObject* ra = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(rin, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED));
  if (!ra) return nullptr;
  const npy_intp b = PyArray_SIZE(ra);
  const float* r = static_cast<const float*>(PyArray_DATA(ra));
  npy_intp dims[1] = {b};
  PyObject* hio = PyArray_SimpleNew(1, dims, NPY_FLOAT32);
  PyObject* loo = PyArray_SimpleNew(1, dims, NPY_FLOAT32);
  PyObject* ifo = PyArray_SimpleNew(1, dims, NPY_FLOAT32);
  float* hi = static_cast<float*>(PyArray_DATA(reinterpret_cast<PyArrayObject*>(hio)));
  float* lo = static_cast<float*>(PyArray_DATA(reinterpret_cast<PyArrayObject*>(loo)));
  float* ifr = static_cast<float*>(PyArray_DATA(reinterpret_cast<PyArrayObject*>(ifo)));
  const float fsvs32 = static_cast<float>(fsvs);
  for (npy_intp i = 0; i < b; i++) {
    double u = static_cast<double>(fsvs32) * static_cast<double>(r[i]) /
               static_cast<double>(num_bins);
    float uh = static_cast<float>(u);
    uint32_t bits_;
    std::memcpy(&bits_, &uh, 4);
    bits_ &= 0xFFFFF000u;  // keep sign+exp+top-12 mantissa bits (mask low 12)
    std::memcpy(&uh, &bits_, 4);
    hi[i] = uh;
    lo[i] = static_cast<float>(u - static_cast<double>(uh));
    float frac = 1.0f + fsvs32 * r[i] * r[i];
    ifr[i] = 1.0f / frac;
  }
  Py_DECREF(ra);
  return Py_BuildValue("(NNN)", hio, loo, ifo);
}

PyMethodDef methods[] = {
    {"decode_wav", decode_wav, METH_VARARGS, "decode WAV bytes -> (float32[frames,ch], rate)"},
    {"encode_pcm", encode_pcm, METH_VARARGS, "float32 array, bits -> PCM bytes"},
    {"fed_stream", fed_stream, METH_VARARGS, "wrapping playhead stream"},
    {"build_segments", build_segments, METH_VARARGS, "overlap-save windows"},
    {"pick_hrtf", pick_hrtf, METH_VARARGS, "nearest KEMAR filter index scan"},
    {"interp_plan", interp_plan, METH_VARARGS,
     "interpolationCalculations: (idx, weights, omegas, case) per position"},
    {"distance_phase_split", distance_phase_split, METH_VARARGS,
     "float64-accurate 12-bit phase split for the distance factor"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef mod = {PyModuleDef_HEAD_INIT, "_jefferson_native",
                   "native host runtime for jefferson_tpu", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__jefferson_native(void) {
  PyObject* m = PyModule_Create(&mod);
  if (!m) return nullptr;
  import_array();
  return m;
}
