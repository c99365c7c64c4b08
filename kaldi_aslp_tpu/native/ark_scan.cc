// Native ark scanner: the data-loader hot path in C++.
//
// JAX-native equivalent of the reference's C++ Table I/O layer
// (reference: src/util/kaldi-table-inl.h SequentialTableReader +
// src/matrix/kaldi-matrix.cc Matrix::Read): one pass over an ark buffer
// records every entry's key and payload geometry so Python wraps the
// float data as zero-copy numpy views instead of byte-looping.
//
// Exposed as plain C functions for ctypes (no CPython API), built with
// `cc -O2 -shared -fPIC` on first use (see native/__init__.py).

#include <cstdint>
#include <cstring>

extern "C" {

// entry kinds
enum {
  KIND_UNKNOWN = 0,
  KIND_FM = 1,   // float matrix
  KIND_DM = 2,   // double matrix
  KIND_FV = 3,   // float vector
  KIND_IV = 4,   // int32 vector (alignment)
  KIND_CM = 5,   // compressed matrix fmt 1
  KIND_CM2 = 6,
  KIND_CM3 = 7,
};

struct ArkEntry {
  int64_t key_off;
  int32_t key_len;
  int32_t kind;
  int64_t data_off;  // offset of raw payload (after dims)
  int32_t rows;
  int32_t cols;
};

static inline int32_t read_i32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// Scan one ark buffer. Returns number of entries found, or -1 on parse
// error, or -2 if out capacity exhausted (partial results valid).
int64_t ark_scan(const uint8_t* buf, int64_t n, ArkEntry* out,
                 int64_t max_entries) {
  int64_t pos = 0;
  int64_t count = 0;
  while (pos < n) {
    // skip whitespace
    while (pos < n && (buf[pos] == ' ' || buf[pos] == '\n' ||
                       buf[pos] == '\t' || buf[pos] == '\r'))
      pos++;
    if (pos >= n) break;
    // key
    int64_t key_off = pos;
    while (pos < n && buf[pos] != ' ' && buf[pos] != '\t') pos++;
    if (pos >= n) return -1;
    int32_t key_len = (int32_t)(pos - key_off);
    pos++;  // the single separating space
    // binary marker \0B
    if (pos + 2 > n || buf[pos] != 0x00 || buf[pos + 1] != 'B')
      return -1;  // text entries not handled natively
    pos += 2;
    if (count >= max_entries) return -2;
    ArkEntry* e = &out[count];
    e->key_off = key_off;
    e->key_len = key_len;
    e->kind = KIND_UNKNOWN;
    // token or int-vector size byte
    if (buf[pos] == 0x04) {
      // WriteIntegerVector: \4 + int32 n + n*int32
      if (pos + 5 > n) return -1;
      int32_t len = read_i32(buf + pos + 1);
      e->kind = KIND_IV;
      e->rows = len;
      e->cols = 1;
      e->data_off = pos + 5;
      pos += 5 + (int64_t)len * 4;
    } else {
      // token up to space
      int64_t tok_off = pos;
      while (pos < n && buf[pos] != ' ') pos++;
      if (pos >= n) return -1;
      int64_t tok_len = pos - tok_off;
      pos++;  // space
      const char* tok = (const char*)(buf + tok_off);
      int itemsize = 4;
      if (tok_len == 2 && !std::strncmp(tok, "FM", 2)) {
        e->kind = KIND_FM;
      } else if (tok_len == 2 && !std::strncmp(tok, "DM", 2)) {
        e->kind = KIND_DM;
        itemsize = 8;
      } else if (tok_len == 2 && !std::strncmp(tok, "FV", 2)) {
        e->kind = KIND_FV;
      } else if (tok_len == 2 && !std::strncmp(tok, "CM", 2)) {
        e->kind = KIND_CM;
      } else if (tok_len == 3 && !std::strncmp(tok, "CM2", 3)) {
        e->kind = KIND_CM2;
      } else if (tok_len == 3 && !std::strncmp(tok, "CM3", 3)) {
        e->kind = KIND_CM3;
      } else {
        return -1;
      }
      if (e->kind == KIND_FM || e->kind == KIND_DM) {
        if (pos + 10 > n || buf[pos] != 0x04 || buf[pos + 5] != 0x04)
          return -1;
        e->rows = read_i32(buf + pos + 1);
        e->cols = read_i32(buf + pos + 6);
        e->data_off = pos + 10;
        pos = e->data_off + (int64_t)e->rows * e->cols * itemsize;
      } else if (e->kind == KIND_FV) {
        if (pos + 5 > n || buf[pos] != 0x04) return -1;
        e->rows = read_i32(buf + pos + 1);
        e->cols = 1;
        e->data_off = pos + 5;
        pos = e->data_off + (int64_t)e->rows * 4;
      } else {
        // compressed: global header = 2 floats + 2 int32
        if (pos + 16 > n) return -1;
        e->rows = read_i32(buf + pos + 8);
        e->cols = read_i32(buf + pos + 12);
        e->data_off = pos;  // header included (python decodes)
        int64_t body;
        if (e->kind == KIND_CM)
          body = 16 + 8LL * e->cols + (int64_t)e->rows * e->cols;
        else if (e->kind == KIND_CM2)
          body = 16 + 2LL * e->rows * e->cols;
        else
          body = 16 + (int64_t)e->rows * e->cols;
        pos += body;
      }
    }
    if (pos > n) return -1;
    count++;
  }
  return count;
}

// Gather rows from an FM payload into a contiguous float buffer
// (random-access minibatch assembly without intermediate numpy copies).
void gather_rows_f32(const uint8_t* buf, int64_t data_off, int32_t cols,
                     const int64_t* row_indices, int64_t num_rows,
                     float* out) {
  const float* base = (const float*)(buf + data_off);
  for (int64_t i = 0; i < num_rows; i++) {
    std::memcpy(out + i * cols, base + row_indices[i] * cols,
                sizeof(float) * cols);
  }
}

}  // extern "C"
