// FLAC decoder for the host data plane (a host C++ library, not a kernel).
//
// The same decoder as the JAX package's native/flac_decode.cpp, kept here so
// the port loads no library of the JAX package. The reference reads AudioSet
// and AudioCaps clips from .flac files through libsndfile
// (utils/dataset.py:202, utilities.py:62-124 flac naming); neither machine
// has libsndfile or ffmpeg, so decoding needs a first-party decoder.
// Implements the full fixed-blocksize FLAC subset produced by the reference
// encoder family: CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes,
// Rice residual methods 0 and 1 with escape partitions, wasted bits, all
// stereo decorrelation modes (L/S, R/S, M/S), 8..32-bit samples, UTF-8
// coded frame numbers, and CRC-8/CRC-16 verification.
//
// Entry points (ctypes, see data/flac.py): flac_info + flac_decode.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
    const uint8_t* data;
    int64_t nbytes;
    int64_t pos = 0;  // bit position
    bool fail = false;

    int64_t byte_pos() const { return pos >> 3; }
    bool aligned() const { return (pos & 7) == 0; }
    void align() { pos = (pos + 7) & ~int64_t(7); }

    uint32_t bit() {
        if (pos >= nbytes * 8) { fail = true; return 0; }
        uint32_t b = (data[pos >> 3] >> (7 - (pos & 7))) & 1u;
        ++pos;
        return b;
    }

    uint64_t bits64(int n) {
        uint64_t v = 0;
        if (n == 0) return 0;
        if (pos + n > nbytes * 8) { fail = true; return 0; }
        // fast path: byte-at-a-time
        while (n >= 8 && (pos & 7) == 0) {
            v = (v << 8) | data[pos >> 3];
            pos += 8;
            n -= 8;
        }
        while (n > 0) {
            v = (v << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1u);
            ++pos;
            --n;
        }
        return v;
    }

    uint32_t bits(int n) { return static_cast<uint32_t>(bits64(n)); }

    int64_t sbits(int n) {  // two's-complement signed
        uint64_t v = bits64(n);
        if (n > 0 && (v >> (n - 1)) & 1u) {
            return static_cast<int64_t>(v) - (int64_t(1) << n);
        }
        return static_cast<int64_t>(v);
    }

    int64_t unary() {  // count of 0 bits before the terminating 1
        int64_t q = 0;
        for (;;) {
            if (pos >= nbytes * 8) { fail = true; return 0; }
            if ((data[pos >> 3] >> (7 - (pos & 7))) & 1u) { ++pos; return q; }
            ++pos;
            ++q;
        }
    }
};

uint8_t crc8(const uint8_t* d, int64_t n) {  // poly x^8+x^2+x^1+1 (0x07)
    uint8_t c = 0;
    for (int64_t i = 0; i < n; ++i) {
        c ^= d[i];
        for (int k = 0; k < 8; ++k) c = (c & 0x80) ? uint8_t((c << 1) ^ 0x07) : uint8_t(c << 1);
    }
    return c;
}

uint16_t crc16(const uint8_t* d, int64_t n) {  // poly 0x8005
    uint16_t c = 0;
    for (int64_t i = 0; i < n; ++i) {
        c ^= uint16_t(d[i]) << 8;
        for (int k = 0; k < 8; ++k) c = (c & 0x8000) ? uint16_t((c << 1) ^ 0x8005) : uint16_t(c << 1);
    }
    return c;
}

// UTF-8-style coded number (frame/sample index), up to 7 bytes / 36 bits.
bool read_coded_number(BitReader& br, uint64_t* out) {
    uint32_t b0 = br.bits(8);
    if (br.fail) return false;
    int ones = 0;
    while (ones < 8 && (b0 & (0x80u >> ones))) ++ones;
    if (ones == 1 || ones > 7) return false;
    uint64_t v = ones == 0 ? b0 : (b0 & (0x7Fu >> ones));
    for (int i = 1; i < std::max(ones, 1); ++i) {
        uint32_t b = br.bits(8);
        if (br.fail || (b & 0xC0u) != 0x80u) return false;
        v = (v << 6) | (b & 0x3Fu);
    }
    *out = v;
    return true;
}

struct StreamInfo {
    int64_t sample_rate = 0;
    int channels = 0;
    int bits = 0;
    int64_t total_samples = 0;   // 0 = unknown
    int64_t first_frame_byte = 0;
};

// Parse "fLaC" + metadata blocks; fill STREAMINFO. Returns 0 on success.
int parse_header(const uint8_t* d, int64_t n, StreamInfo* si) {
    if (n < 42 || std::memcmp(d, "fLaC", 4) != 0) return 1;
    int64_t p = 4;
    bool have_streaminfo = false;
    for (;;) {
        if (p + 4 > n) return 2;
        bool last = d[p] & 0x80;
        int type = d[p] & 0x7F;
        int64_t len = (int64_t(d[p + 1]) << 16) | (int64_t(d[p + 2]) << 8) | d[p + 3];
        p += 4;
        if (p + len > n) return 3;
        if (type == 0) {  // STREAMINFO
            if (len < 34) return 4;
            const uint8_t* s = d + p;
            si->sample_rate = (int64_t(s[10]) << 12) | (int64_t(s[11]) << 4) | (s[12] >> 4);
            si->channels = ((s[12] >> 1) & 0x7) + 1;
            si->bits = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1;
            si->total_samples = (int64_t(s[13] & 0x0F) << 32) | (int64_t(s[14]) << 24) |
                                (int64_t(s[15]) << 16) | (int64_t(s[16]) << 8) | s[17];
            have_streaminfo = true;
        }
        p += len;
        if (last) break;
    }
    if (!have_streaminfo || si->sample_rate == 0) return 5;
    si->first_frame_byte = p;
    return 0;
}

// Decode one subframe into x[0..blocksize). bps includes any side-channel
// +1. Returns false on malformed data.
bool decode_subframe(BitReader& br, int64_t blocksize, int bps,
                     std::vector<int64_t>& x) {
    if (br.bit() != 0) return false;  // padding bit
    uint32_t type = br.bits(6);
    uint32_t wasted = 0;
    if (br.bit()) wasted = static_cast<uint32_t>(br.unary()) + 1;
    if (br.fail) return false;
    int ebps = bps - static_cast<int>(wasted);
    if (ebps <= 0 || ebps > 33) return false;

    auto read_residual = [&](int order) -> bool {
        uint32_t method = br.bits(2);
        if (method > 1) return false;
        int plen = method == 0 ? 4 : 5;
        uint32_t escape = method == 0 ? 0xF : 0x1F;
        uint32_t po = br.bits(4);
        int64_t nparts = int64_t(1) << po;
        if ((blocksize >> po) << po != blocksize) return false;
        if (blocksize >> po <= order && po > 0) return false;
        int64_t idx = order;
        for (int64_t part = 0; part < nparts; ++part) {
            int64_t cnt = (blocksize >> po) - (part == 0 ? order : 0);
            if (cnt < 0) return false;
            uint32_t param = br.bits(plen);
            if (br.fail) return false;
            if (param == escape) {
                uint32_t raw = br.bits(5);
                for (int64_t i = 0; i < cnt; ++i) x[idx++] = raw ? br.sbits(raw) : 0;
            } else {
                for (int64_t i = 0; i < cnt; ++i) {
                    int64_t q = br.unary();
                    uint64_t r = br.bits64(param);
                    uint64_t u = (uint64_t(q) << param) | r;
                    x[idx++] = (u >> 1) ^ (~(u & 1) + 1);  // zigzag
                }
            }
            if (br.fail) return false;
        }
        return idx == blocksize;
    };

    if (type == 0) {  // CONSTANT
        int64_t v = br.sbits(ebps);
        std::fill(x.begin(), x.begin() + blocksize, v);
    } else if (type == 1) {  // VERBATIM
        for (int64_t i = 0; i < blocksize; ++i) x[i] = br.sbits(ebps);
    } else if (type >= 8 && type <= 12) {  // FIXED, order 0-4
        int order = type - 8;
        if (order > blocksize) return false;
        for (int i = 0; i < order; ++i) x[i] = br.sbits(ebps);
        if (!read_residual(order)) return false;
        switch (order) {
            case 0: break;
            case 1:
                for (int64_t i = 1; i < blocksize; ++i) x[i] += x[i - 1];
                break;
            case 2:
                for (int64_t i = 2; i < blocksize; ++i) x[i] += 2 * x[i - 1] - x[i - 2];
                break;
            case 3:
                for (int64_t i = 3; i < blocksize; ++i)
                    x[i] += 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3];
                break;
            case 4:
                for (int64_t i = 4; i < blocksize; ++i)
                    x[i] += 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4];
                break;
        }
    } else if (type >= 32) {  // LPC, order 1-32
        int order = static_cast<int>(type & 31) + 1;
        if (order > blocksize) return false;
        for (int i = 0; i < order; ++i) x[i] = br.sbits(ebps);
        uint32_t prec = br.bits(4);
        if (prec == 15) return false;
        int precision = static_cast<int>(prec) + 1;
        int shift = static_cast<int>(br.sbits(5));
        if (shift < 0) return false;
        int64_t coef[32];
        for (int i = 0; i < order; ++i) coef[i] = br.sbits(precision);
        if (br.fail) return false;
        if (!read_residual(order)) return false;
        for (int64_t i = order; i < blocksize; ++i) {
            int64_t acc = 0;
            for (int j = 0; j < order; ++j) acc += coef[j] * x[i - 1 - j];
            x[i] += acc >> shift;
        }
    } else {
        return false;  // reserved type
    }
    if (br.fail) return false;
    if (wasted) {
        for (int64_t i = 0; i < blocksize; ++i)
            x[i] = static_cast<int64_t>(static_cast<uint64_t>(x[i]) << wasted);
    }
    return true;
}

}  // namespace

extern "C" {

struct FlacInfo {
    int64_t sample_rate;
    int64_t channels;
    int64_t bits;
    int64_t frames;  // total samples per channel (0 = unknown in STREAMINFO)
};

// Parse the stream header. Returns 0 on success.
int flac_info(const uint8_t* data, int64_t n, FlacInfo* out) {
    StreamInfo si;
    int rc = parse_header(data, n, &si);
    if (rc != 0) return rc;
    out->sample_rate = si.sample_rate;
    out->channels = si.channels;
    out->bits = si.bits;
    out->frames = si.total_samples;
    return 0;
}

// Decode the whole stream to float32 in [-1, 1).
//  - mono != 0: channel-mean into dst[capacity]
//  - mono == 0: interleaved frames into dst[capacity * channels]
// capacity = max frames to write. *out_frames receives the decoded count.
// Returns 0 on success, nonzero error code on malformed input / overflow.
int flac_decode(const uint8_t* data, int64_t n, float* dst, int64_t capacity,
                int mono, int64_t* out_frames) {
    StreamInfo si;
    if (parse_header(data, n, &si) != 0) return 10;
    const int nch = si.channels;
    if (nch < 1 || nch > 8) return 11;

    BitReader br{data, n};
    br.pos = si.first_frame_byte * 8;

    std::vector<std::vector<int64_t>> ch(nch);
    int64_t written = 0;

    while (br.byte_pos() < n) {
        // allow trailing padding bytes of zeros after the last frame
        int64_t frame_start = br.byte_pos();
        uint32_t sync = br.bits(14);
        if (br.fail) break;
        if (sync != 0x3FFE) return 12;
        if (br.bit() != 0) return 12;        // reserved
        br.bit();                            // blocking strategy (either ok)
        uint32_t bs_code = br.bits(4);
        uint32_t sr_code = br.bits(4);
        uint32_t ch_code = br.bits(4);
        uint32_t ss_code = br.bits(3);
        if (br.bit() != 0) return 13;        // reserved
        uint64_t coded_num;
        if (!read_coded_number(br, &coded_num)) return 14;

        int64_t blocksize;
        switch (bs_code) {
            case 0: return 15;
            case 1: blocksize = 192; break;
            case 6: blocksize = int64_t(br.bits(8)) + 1; break;
            case 7: blocksize = int64_t(br.bits(16)) + 1; break;
            default:
                blocksize = bs_code <= 5 ? (576 << (bs_code - 2))
                                         : (256 << (bs_code - 8));
        }
        if (sr_code == 12) br.bits(8);
        else if (sr_code == 13 || sr_code == 14) br.bits(16);
        else if (sr_code == 15) return 16;

        // CRC-8 over the header bytes read so far
        int64_t hdr_end = br.byte_pos();
        uint32_t hdr_crc = br.bits(8);
        if (br.fail) return 17;
        if (crc8(data + frame_start, hdr_end - frame_start) != hdr_crc) return 18;

        int bps;
        switch (ss_code) {
            case 0: bps = si.bits; break;
            case 1: bps = 8; break;
            case 2: bps = 12; break;
            case 4: bps = 16; break;
            case 5: bps = 20; break;
            case 6: bps = 24; break;
            case 7: bps = 32; break;
            default: return 19;
        }

        int frame_ch;
        int mode = 0;  // 0 independent, 1 L/S, 2 R/S, 3 M/S
        if (ch_code < 8) {
            frame_ch = static_cast<int>(ch_code) + 1;
        } else if (ch_code <= 10) {
            frame_ch = 2;
            mode = static_cast<int>(ch_code) - 7;
        } else {
            return 20;
        }
        if (frame_ch != nch) return 21;

        for (int c = 0; c < nch; ++c) {
            if (static_cast<int64_t>(ch[c].size()) < blocksize) ch[c].resize(blocksize);
            int sub_bps = bps;
            if ((mode == 1 && c == 1) || (mode == 2 && c == 0) || (mode == 3 && c == 1))
                ++sub_bps;  // the side channel carries one extra bit
            if (!decode_subframe(br, blocksize, sub_bps, ch[c])) return 22;
        }

        br.align();
        int64_t frame_end = br.byte_pos();
        uint32_t f_crc = br.bits(16);
        if (br.fail) return 23;
        if (crc16(data + frame_start, frame_end - frame_start) != f_crc) return 24;

        // stereo decorrelation
        if (mode == 1) {  // left/side: R = L - S
            for (int64_t i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
        } else if (mode == 2) {  // right/side: L = R + S
            for (int64_t i = 0; i < blocksize; ++i) ch[0][i] = ch[1][i] + ch[0][i];
        } else if (mode == 3) {  // mid/side
            for (int64_t i = 0; i < blocksize; ++i) {
                int64_t s = ch[1][i];
                int64_t m = (ch[0][i] << 1) | (s & 1);
                ch[0][i] = (m + s) >> 1;
                ch[1][i] = (m - s) >> 1;
            }
        }

        if (written + blocksize > capacity) return 25;
        const float scale = 1.0f / static_cast<float>(int64_t(1) << (bps - 1));
        if (mono) {
            const float cinv = 1.0f / static_cast<float>(nch);
            for (int64_t i = 0; i < blocksize; ++i) {
                float acc = 0.0f;
                for (int c = 0; c < nch; ++c) acc += static_cast<float>(ch[c][i]);
                dst[written + i] = acc * scale * cinv;
            }
        } else {
            for (int64_t i = 0; i < blocksize; ++i)
                for (int c = 0; c < nch; ++c)
                    dst[(written + i) * nch + c] = static_cast<float>(ch[c][i]) * scale;
        }
        written += blocksize;

        // stop at the declared total; tolerate trailing zero padding
        if (si.total_samples > 0 && written >= si.total_samples) break;
        // skip any zero padding between frames? (spec: frames are contiguous)
        if (br.byte_pos() >= n) break;
        // peek: all-zero tail means the stream is done
        bool all_zero = true;
        for (int64_t p2 = br.byte_pos(); p2 < std::min(n, br.byte_pos() + 4); ++p2)
            if (data[p2] != 0) { all_zero = false; break; }
        if (all_zero && si.total_samples > 0) break;
    }

    if (si.total_samples > 0 && written != si.total_samples) {
        // tolerate encoders writing exactly total_samples across frames where
        // the last frame is shorter; anything else is an error
        if (written < si.total_samples) return 26;
        written = si.total_samples;
    }
    *out_frames = written;
    return 0;
}

}  // extern "C"
