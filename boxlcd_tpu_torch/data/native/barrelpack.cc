// barrelpack: native bit-packing codec for binarized LCD frame tensors.
//
// The data path writes [episodes, T, H, W] boolean frames; packing to bits
// cuts barrel size/IO 8x vs byte-bools before compression. This is the
// framework's native runtime component for dataset IO (the TPU-native
// counterpart of the reference's C-backed PIL/npz path).
//
// Exposed as a plain C ABI for ctypes.
#include <cstdint>
#include <cstddef>

extern "C" {

// pack n_bytes boolean bytes (0/1) into ceil(n/8) bit-packed bytes (MSB first,
// numpy packbits convention)
void pack_bits(const uint8_t* src, size_t n, uint8_t* dst) {
  size_t nbytes = (n + 7) / 8;
  for (size_t i = 0; i < nbytes; ++i) {
    uint8_t acc = 0;
    size_t base = i * 8;
    size_t lim = base + 8 <= n ? 8 : n - base;
    for (size_t b = 0; b < lim; ++b) {
      acc |= (src[base + b] & 1) << (7 - b);
    }
    dst[i] = acc;
  }
}

// unpack bit-packed bytes into n boolean bytes
void unpack_bits(const uint8_t* src, size_t n, uint8_t* dst) {
  for (size_t i = 0; i < n; ++i) {
    dst[i] = (src[i / 8] >> (7 - (i % 8))) & 1;
  }
}

// run-length encode a bit-packed stream (XOR delta between consecutive
// frames compresses nearly-static LCD video extremely well)
// frames: [T, frame_bytes] packed; out must hold T*frame_bytes bytes.
// Returns bytes written: first frame raw, then XOR deltas.
size_t xor_delta_encode(const uint8_t* frames, size_t t, size_t frame_bytes,
                        uint8_t* out) {
  for (size_t i = 0; i < frame_bytes; ++i) out[i] = frames[i];
  for (size_t f = 1; f < t; ++f) {
    const uint8_t* cur = frames + f * frame_bytes;
    const uint8_t* prev = frames + (f - 1) * frame_bytes;
    uint8_t* o = out + f * frame_bytes;
    for (size_t i = 0; i < frame_bytes; ++i) o[i] = cur[i] ^ prev[i];
  }
  return t * frame_bytes;
}

size_t xor_delta_decode(const uint8_t* enc, size_t t, size_t frame_bytes,
                        uint8_t* out) {
  for (size_t i = 0; i < frame_bytes; ++i) out[i] = enc[i];
  for (size_t f = 1; f < t; ++f) {
    const uint8_t* e = enc + f * frame_bytes;
    const uint8_t* prev = out + (f - 1) * frame_bytes;
    uint8_t* o = out + f * frame_bytes;
    for (size_t i = 0; i < frame_bytes; ++i) o[i] = e[i] ^ prev[i];
  }
  return t * frame_bytes;
}

}  // extern "C"
