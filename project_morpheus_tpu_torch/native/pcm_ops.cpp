// Native PCM primitives for the streaming host path (port of the JAX
// package's native/pcm_ops.cpp, same functions and semantics).
//
// The host-side PCM plumbing -- ring buffer, crossfade join, float->int16
// conversion, metering -- as a small C++ library bound with ctypes.  The
// Python implementations in orchestrator/ are the default path and the
// oracle of the equivalence tests (tests/test_torch_native.py).
//
// Built at first use by native/__init__.py:
//   g++ -O3 -ffp-contract=off -shared -fPIC -o libpcm_ops-<hash>.so pcm_ops.cpp
// (-ffp-contract=off: no fused multiply-add, so the crossfade rounds as
// numpy's float32 arithmetic does.)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

// ----------------------------------------------------------- ring buffer

struct PcmRing {
    std::vector<uint8_t> buf;
    size_t cap;
    size_t rd;
    size_t wr;
    size_t size;
};

PcmRing* pcm_ring_create(size_t capacity) {
    auto* r = new PcmRing();
    r->buf.resize(capacity);
    r->cap = capacity;
    r->rd = r->wr = r->size = 0;
    return r;
}

void pcm_ring_destroy(PcmRing* r) { delete r; }

size_t pcm_ring_size(const PcmRing* r) { return r->size; }

size_t pcm_ring_free(const PcmRing* r) { return r->cap - r->size; }

// Writes up to free-space bytes; returns bytes written.
size_t pcm_ring_write(PcmRing* r, const uint8_t* data, size_t n) {
    n = std::min(n, r->cap - r->size);
    if (n == 0) return 0;
    size_t first = std::min(n, r->cap - r->wr);
    std::memcpy(r->buf.data() + r->wr, data, first);
    if (n > first) std::memcpy(r->buf.data(), data + first, n - first);
    r->wr = (r->wr + n) % r->cap;
    r->size += n;
    return n;
}

// Pops up to n bytes into out; returns bytes read.
size_t pcm_ring_read(PcmRing* r, uint8_t* out, size_t n) {
    n = std::min(n, r->size);
    if (n == 0) return 0;
    size_t first = std::min(n, r->cap - r->rd);
    std::memcpy(out, r->buf.data() + r->rd, first);
    if (n > first) std::memcpy(out + first, r->buf.data(), n - first);
    r->rd = (r->rd + n) % r->cap;
    r->size -= n;
    return n;
}

void pcm_ring_reset(PcmRing* r) { r->rd = r->wr = r->size = 0; }

// ------------------------------------------------------------- crossfade

// Overlap-add join: out = tail[:-ov] ++ mix(tail[-ov:], head[:ov]) ++ head[ov:]
// with linear fades; ov clamped to both sizes.  Returns output length in
// samples; out must hold tail_n + head_n samples.
size_t pcm_crossfade_join(const int16_t* tail, size_t tail_n,
                          const int16_t* head, size_t head_n,
                          size_t overlap, int16_t* out) {
    size_t ov = std::min({overlap, tail_n, head_n});
    size_t pre = tail_n - ov;
    std::memcpy(out, tail, pre * sizeof(int16_t));
    for (size_t i = 0; i < ov; ++i) {
        float t = static_cast<float>(i) / static_cast<float>(ov);
        float mixed = static_cast<float>(tail[pre + i]) * (1.0f - t) +
                      static_cast<float>(head[i]) * t;
        mixed = std::max(-32768.0f, std::min(32767.0f, mixed));
        out[pre + i] = static_cast<int16_t>(mixed);
    }
    std::memcpy(out + pre + ov, head + ov, (head_n - ov) * sizeof(int16_t));
    return pre + ov + (head_n - ov);
}

// --------------------------------------------------------- conversions

// float [-1, 1] -> int16 with the reference's scale-truncate semantics
// (speechpipe.py:127: multiply by 32767, truncate toward zero).
void pcm_f32_to_i16(const float* in, size_t n, int16_t* out) {
    for (size_t i = 0; i < n; ++i) {
        float v = in[i] * 32767.0f;
        v = std::max(-32768.0f, std::min(32767.0f, v));
        out[i] = static_cast<int16_t>(v);
    }
}

void pcm_i16_to_f32(const int16_t* in, size_t n, float* out) {
    for (size_t i = 0; i < n; ++i) out[i] = static_cast<float>(in[i]) / 32767.0f;
}

// ------------------------------------------------------------- metering

// Returns RMS in [0,1]; writes peak (absolute, [0,1]) to *peak.
double pcm_meter(const int16_t* in, size_t n, double* peak) {
    double acc = 0.0, pk = 0.0;
    for (size_t i = 0; i < n; ++i) {
        double v = std::abs(static_cast<double>(in[i])) / 32768.0;
        acc += v * v;
        pk = std::max(pk, v);
    }
    if (peak) *peak = pk;
    return n ? std::sqrt(acc / static_cast<double>(n)) : 0.0;
}

}  // extern "C"
