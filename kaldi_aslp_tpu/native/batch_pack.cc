// Native batch assembly for the training input pipeline.
//
// The reference assembles multi-stream minibatches in C++ (stream
// filling + padding, src/aslp-nnet/data-reader.cc:200-344); this is the
// JAX-framework equivalent for the host side of the pipeline: a single
// pass that pads variable-length [T_i, D] float32 feature matrices into
// one [S, T_max, D] buffer, optionally fused with the wire-format cast
// (bf16 round-to-nearest-even, or per-dim affine int8 quantization —
// see kaldi_aslp_tpu/data/transport.py for the format contract the
// Python fallback defines).
//
// Built by kaldi_aslp_tpu/native/__init__.py with the system compiler;
// every entry point has a pure-numpy fallback.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Pad to [S, Tmax, D] float32; padding rows are exact 0.0f.
void pad_batch_f32(const float** feats, const int32_t* lens, int32_t S,
                   int32_t Tmax, int32_t D, float* out) {
  for (int32_t s = 0; s < S; ++s) {
    float* row = out + (int64_t)s * Tmax * D;
    const int64_t n = (int64_t)lens[s] * D;
    std::memcpy(row, feats[s], n * sizeof(float));
    std::memset(row + n, 0, ((int64_t)Tmax * D - n) * sizeof(float));
  }
}

static inline uint16_t f32_to_bf16_rne(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  const uint32_t lsb = (u >> 16) & 1u;
  return (uint16_t)((u + 0x7FFFu + lsb) >> 16);
}

// Pad + cast to bf16 (round-to-nearest-even) in one pass.
void pad_batch_bf16(const float** feats, const int32_t* lens, int32_t S,
                    int32_t Tmax, int32_t D, uint16_t* out) {
  for (int32_t s = 0; s < S; ++s) {
    uint16_t* row = out + (int64_t)s * Tmax * D;
    const float* src = feats[s];
    const int64_t n = (int64_t)lens[s] * D;
    for (int64_t i = 0; i < n; ++i) row[i] = f32_to_bf16_rne(src[i]);
    std::memset(row + n, 0, ((int64_t)Tmax * D - n) * sizeof(uint16_t));
  }
}

// Pad + per-dim affine int8 quantization in one fused pass
// (two sweeps: per-dim min/max over real frames, then quantize).
// Contract matches data/transport.py pack_feats("int8"):
//   scale[d]  = max(hi - lo, 1e-10) / 254
//   offset[d] = lo
//   q         = rint((x - offset) / scale) - 127
// Padding bytes are the quantization of 0.0 AT x=offset, i.e. -127; the
// device-side dequant re-zeroes padding from the length vector, so any
// value is acceptable — -127 keeps the buffer deterministic.
void pad_batch_int8(const float** feats, const int32_t* lens, int32_t S,
                    int32_t Tmax, int32_t D, int8_t* out, float* scale,
                    float* offset) {
  for (int32_t d = 0; d < D; ++d) {
    scale[d] = -3.4e38f;   // running hi
    offset[d] = 3.4e38f;   // running lo
  }
  for (int32_t s = 0; s < S; ++s) {
    const float* src = feats[s];
    for (int32_t t = 0; t < lens[s]; ++t, src += D) {
      for (int32_t d = 0; d < D; ++d) {
        const float v = src[d];
        scale[d] = v > scale[d] ? v : scale[d];
        offset[d] = v < offset[d] ? v : offset[d];
      }
    }
  }
  for (int32_t d = 0; d < D; ++d) {
    float range = scale[d] - offset[d];
    if (!(range > 1e-10f)) range = 1e-10f;
    scale[d] = range / 254.0f;
  }
  for (int32_t s = 0; s < S; ++s) {
    int8_t* row = out + (int64_t)s * Tmax * D;
    const float* src = feats[s];
    for (int32_t t = 0; t < lens[s]; ++t, src += D, row += D) {
      for (int32_t d = 0; d < D; ++d) {
        row[d] = (int8_t)(std::nearbyintf((src[d] - offset[d])
                                          / scale[d]) - 127.0f);
      }
    }
    std::memset(row, -127, (size_t)((int64_t)(Tmax - lens[s]) * D));
  }
}

}  // extern "C"
