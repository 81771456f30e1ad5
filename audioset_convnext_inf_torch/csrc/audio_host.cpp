// Host-side audio data plane of the PyTorch port.
//
// The reference delegates its hot host loops (int16 decode, pad/truncate,
// WAV parsing, polyphase resampling) to numpy, scipy and soundfile inside
// DataLoader worker processes; here they are C++ with OpenMP and
// auto-vectorization, called through ctypes (utils/native.py). The numpy and
// scipy versions of the same functions stay in utils/native.py as the plain
// versions the tests hold this library against.
//
// Built at first use by utils/host_build.py with the host compiler:
//   $CXX -O3 -fPIC -fopenmp -Wall -std=c++17 -c audio_host.cpp -o <obj>
//   $CXX <obj> -o <lib> -shared -l:libgomp.so.1
// into build/host_libs/libaudio_host_<hash of flags and source>.so.

#include <algorithm>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// int16 -> float32, x / 32767 (reference utilities.py:226-227)
void int16_to_float32(const int16_t* src, float* dst, int64_t n) {
    const float scale = 1.0f / 32767.0f;
#pragma omp parallel for schedule(static) if (n > 1 << 16)
    for (int64_t i = 0; i < n; ++i) {
        dst[i] = static_cast<float>(src[i]) * scale;
    }
}

// float32 -> int16 with clip to [-1, 1] (reference utilities.py:220-223)
void float32_to_int16(const float* src, int16_t* dst, int64_t n) {
#pragma omp parallel for schedule(static) if (n > 1 << 16)
    for (int64_t i = 0; i < n; ++i) {
        float v = src[i];
        v = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
        dst[i] = static_cast<int16_t>(v * 32767.0f);
    }
}

// Batch decode: n_items rows of int16[src_len] -> float32[dst_len] rows,
// zero-padding the tail or truncating (decode + pad_or_truncate fused).
void decode_batch_int16(const int16_t* src, int64_t n_items, int64_t src_len,
                        float* dst, int64_t dst_len) {
    const float scale = 1.0f / 32767.0f;
    const int64_t copy = std::min(src_len, dst_len);
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < n_items; ++r) {
        const int16_t* s = src + r * src_len;
        float* d = dst + r * dst_len;
        for (int64_t i = 0; i < copy; ++i) {
            d[i] = static_cast<float>(s[i]) * scale;
        }
        if (dst_len > copy) {
            std::memset(d + copy, 0, sizeof(float) * (dst_len - copy));
        }
    }
}

// Strided decimation resample 32k -> 16k/8k (reference data_generator.py:107-123)
void decimate_int16_to_float32(const int16_t* src, int64_t n, int64_t stride,
                               float* dst) {
    const float scale = 1.0f / 32767.0f;
    const int64_t out_n = (n + stride - 1) / stride;
#pragma omp parallel for schedule(static) if (out_n > 1 << 14)
    for (int64_t i = 0; i < out_n; ++i) {
        dst[i] = static_cast<float>(src[i * stride]) * scale;
    }
}

int omp_thread_count() {
#if defined(_OPENMP)
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"

// ---------------------------------------------------------------------------
// WAV (RIFF) parsing + decode (reference host stack: soundfile/scipy wavfile)
// ---------------------------------------------------------------------------
//
// Two-call API: wav_info() scans the chunk list and reports geometry;
// wav_decode() converts the data chunk to float32 in [-1, 1], optionally
// downmixing to mono (channel mean - matching dataset.py:204-207).
// Supported: PCM 8/16/24/32-bit (format 1) and IEEE float32/64 (format 3),
// including WAVE_FORMAT_EXTENSIBLE (0xFFFE) wrapping either.

extern "C" {

struct WavInfo {
    int32_t sample_rate;
    int32_t channels;
    int32_t bits_per_sample;
    int32_t format;      // 1 = PCM, 3 = IEEE float
    int64_t frames;      // samples per channel
    int64_t data_offset; // byte offset of sample data
    int64_t data_bytes;
};

static uint32_t rd_u32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
    return (uint16_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8));
}

// returns 0 on success, negative error code otherwise
int wav_info(const uint8_t* buf, int64_t n, WavInfo* out) {
    if (n < 12 || std::memcmp(buf, "RIFF", 4) != 0 ||
        std::memcmp(buf + 8, "WAVE", 4) != 0) {
        return -1;
    }
    int64_t pos = 12;
    bool have_fmt = false;
    std::memset(out, 0, sizeof(WavInfo));
    while (pos + 8 <= n) {
        const uint8_t* hdr = buf + pos;
        uint32_t size = rd_u32(hdr + 4);
        const int64_t body = pos + 8;
        if (std::memcmp(hdr, "fmt ", 4) == 0 && body + 16 <= n) {
            uint16_t fmt = rd_u16(buf + body);
            out->channels = rd_u16(buf + body + 2);
            out->sample_rate = (int32_t)rd_u32(buf + body + 4);
            out->bits_per_sample = rd_u16(buf + body + 14);
            if (fmt == 0xFFFE && body + 26 <= n) {  // EXTENSIBLE: subformat
                fmt = rd_u16(buf + body + 24);
            }
            out->format = fmt;
            have_fmt = true;
        } else if (std::memcmp(hdr, "data", 4) == 0) {
            out->data_offset = body;
            out->data_bytes = std::min<int64_t>(size, n - body);
        }
        pos = body + size + (size & 1);  // chunks are word-aligned
    }
    if (!have_fmt || out->data_offset == 0 || out->channels <= 0) return -2;
    const int bytes_per = out->bits_per_sample / 8;
    if (bytes_per <= 0) return -3;
    const bool pcm_ok = out->format == 1 &&
        (out->bits_per_sample == 8 || out->bits_per_sample == 16 ||
         out->bits_per_sample == 24 || out->bits_per_sample == 32);
    const bool flt_ok = out->format == 3 &&
        (out->bits_per_sample == 32 || out->bits_per_sample == 64);
    if (!pcm_ok && !flt_ok) return -4;
    out->frames = out->data_bytes / (bytes_per * out->channels);
    return 0;
}

static inline float wav_sample(const uint8_t* p, int format, int bits) {
    switch (bits) {
        case 8:   // PCM unsigned
            return ((float)p[0] - 128.0f) / 128.0f;
        case 16:
            return (float)(int16_t)rd_u16(p) / 32768.0f;
        case 24: {
            int32_t v = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                                  (uint32_t)p[2] << 24) >> 8;
            return (float)v / 8388608.0f;
        }
        case 32:
            if (format == 3) {
                float f;
                std::memcpy(&f, p, 4);
                return f;
            } else {
                int32_t v = (int32_t)rd_u32(p);
                return (float)v / 2147483648.0f;
            }
        case 64: {
            double d;
            std::memcpy(&d, p, 8);
            return (float)d;
        }
    }
    return 0.0f;
}

// Decode to float32. mono != 0: average channels into out[frames];
// else interleaved out[frames * channels].
int wav_decode(const uint8_t* buf, int64_t n, const WavInfo* info, float* out,
               int mono) {
    const int bytes_per = info->bits_per_sample / 8;
    const int ch = info->channels;
    const uint8_t* data = buf + info->data_offset;
    if (info->data_offset + info->frames * (int64_t)bytes_per * ch > n) return -1;
    const int64_t frames = info->frames;
#pragma omp parallel for schedule(static) if (frames > 1 << 15)
    for (int64_t i = 0; i < frames; ++i) {
        const uint8_t* row = data + i * bytes_per * ch;
        if (mono) {
            float acc = 0.0f;
            for (int c = 0; c < ch; ++c) {
                acc += wav_sample(row + c * bytes_per, info->format,
                                  info->bits_per_sample);
            }
            out[i] = acc / (float)ch;
        } else {
            for (int c = 0; c < ch; ++c) {
                out[i * ch + c] = wav_sample(row + c * bytes_per, info->format,
                                             info->bits_per_sample);
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Polyphase resampler core (upfirdn) - scipy.signal.resample_poly semantics
// ---------------------------------------------------------------------------
//
// y[j] = sum_t h[t] * xup[j*down + h_off - t], where xup is the zero-stuffed
// upsampled input (xup[i] = x[i/up] when i % up == 0) and h_off = (nh-1)/2
// centers the (odd-length, symmetric) filter like resample_poly does. The
// caller designs h (Kaiser-windowed sinc, already scaled by `up`) host-side;
// this core is the hot loop. Parallel over output samples - each is an
// independent dot product over ~nh/up input taps.

void resample_upfirdn(const float* x, int64_t n, const double* h, int64_t nh,
                      int64_t up, int64_t down, float* y, int64_t ny) {
    const int64_t h_off = (nh - 1) / 2;
#pragma omp parallel for schedule(static) if (ny > 1 << 12)
    for (int64_t j = 0; j < ny; ++j) {
        const int64_t m = j * down + h_off;  // position in xup space
        // need t with (m - t) % up == 0 and 0 <= (m - t)/up < n
        const int64_t p = m % up;            // first valid t is at t = p
        double acc = 0.0;
        for (int64_t t = p; t < nh; t += up) {
            const int64_t i = (m - t) / up;
            if (i >= 0 && i < n) {
                acc += h[t] * (double)x[i];
            }
        }
        y[j] = (float)acc;
    }
}

}  // extern "C"
