// Block-wise int8 quantization kernels for the collective compression tier.
//
// C ABI consumed via ctypes (ray_tpu_torch/collective/quantization.py); built on
// first use by _native/build.py with vectorization flags — the -O2 default
// does not vectorize the absmax scan and loses to numpy, while -O3
// -march=native turns both loops into packed max/convert and beats the
// fused numpy path ~3x on one core.
//
// Scheme (EQuARX-style dynamic block quantization, arxiv 2506.17615):
// each contiguous block of `block` floats gets one f32 scale =
// absmax/127; payload is round-to-nearest int8 clamped to ±127. The
// tail block may be short. Dequantization fused into the reduction
// (rtq_q8_dequant_add) keeps accumulation at full precision.

#include <cstdint>
#include <cstring>

extern "C" {

// Per-block absmax is found with unsigned-integer compares: for IEEE-754
// floats, |a| <= |b|  <=>  (bits(a) & 0x7fffffff) <= (bits(b) & 0x7fffffff),
// so the scan is a packed AND+MAX with no float semantics for the
// vectorizer to worry about. A block whose absmax is Inf/NaN poisons its
// scale to -1 (payload zeroed); the Python layer rejects negative scales
// loudly instead of shipping silent garbage.
void rtq_q8_quantize(const float* __restrict x, int64_t n, int64_t block,
                     int8_t* __restrict q, float* __restrict scales) {
    const uint32_t* xb = (const uint32_t*)x;
    int64_t nb = (n + block - 1) / block;
    for (int64_t b = 0; b < nb; ++b) {
        int64_t lo = b * block;
        int64_t hi = lo + block < n ? lo + block : n;
        uint32_t am = 0;
        for (int64_t i = lo; i < hi; ++i) {
            uint32_t a = xb[i] & 0x7fffffffu;
            if (a > am) am = a;
        }
        float amf;
        std::memcpy(&amf, &am, 4);
        float scale = amf / 127.0f;
        scales[b] = scale;
        if (scale == 0.0f || am >= 0x7f800000u) {
            if (am >= 0x7f800000u) scales[b] = -1.0f;
            std::memset(q + lo, 0, (size_t)(hi - lo));
            continue;
        }
        float inv = 1.0f / scale;
        for (int64_t i = lo; i < hi; ++i) {
            float v = x[i] * inv;
            q[i] = (int8_t)__builtin_rintf(v);
        }
    }
}

// acc[i] += scale[block(i)] * q[i] — the fused dequant+accumulate that
// keeps the reduction at f32 (quantized ranks never sum in int8).
void rtq_q8_dequant_add(const int8_t* __restrict q,
                        const float* __restrict scales, int64_t n,
                        int64_t block, float* __restrict acc) {
    int64_t nb = (n + block - 1) / block;
    for (int64_t b = 0; b < nb; ++b) {
        int64_t lo = b * block;
        int64_t hi = lo + block < n ? lo + block : n;
        float s = scales[b];
        for (int64_t i = lo; i < hi; ++i) acc[i] += s * (float)q[i];
    }
}

void rtq_q8_dequant(const int8_t* __restrict q,
                    const float* __restrict scales, int64_t n,
                    int64_t block, float* __restrict out) {
    int64_t nb = (n + block - 1) / block;
    for (int64_t b = 0; b < nb; ++b) {
        int64_t lo = b * block;
        int64_t hi = lo + block < n ? lo + block : n;
        float s = scales[b];
        for (int64_t i = lo; i < hi; ++i) out[i] = s * (float)q[i];
    }
}

}  // extern "C"
