// Native audio decode/resample for the host side of avex_tpu_torch (a copy of
// avex_tpu/_native/audio_native.cpp; the port imports nothing of the JAX
// package).
//
// The reference delegates audio IO to torchaudio/soundfile (C/C++ under the
// hood); this is a small, dependency-free C++ library exposed over a C ABI
// and loaded via ctypes: RIFF/WAV parsing (PCM16/24/32 + float32), FLAC
// decoding, channel mixdown and windowed-sinc resampling, so Python never
// touches samples one by one. Host code only: no device kernel.
//
// Build (done at first use by avex_tpu_torch/_native/__init__.py):
//   g++ -O3 -shared -fPIC audio_native.cpp -o libavexaudio.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// Parse a RIFF/WAV buffer. Returns 0 on success.
// On success *sample_rate / *channels / *frames describe the data; when
// `out` is non-null it receives frames*channels float32 samples in [-1, 1]
// (caller sizes it from a first metadata-only call with out == nullptr).
int avex_decode_wav(const uint8_t* data, int64_t len,
                    float* out, int64_t out_capacity,
                    int32_t* sample_rate, int32_t* channels, int64_t* frames) {
    if (len < 44 || std::memcmp(data, "RIFF", 4) != 0 || std::memcmp(data + 8, "WAVE", 4) != 0)
        return -1;

    int64_t pos = 12;
    int16_t audio_format = 0, num_channels = 0, bits = 0;
    int32_t rate = 0;
    const uint8_t* pcm = nullptr;
    int64_t pcm_len = 0;

    while (pos + 8 <= len) {
        const uint8_t* chunk_id = data + pos;
        uint32_t chunk_size;
        std::memcpy(&chunk_size, data + pos + 4, 4);
        const uint8_t* body = data + pos + 8;
        if (pos + 8 + (int64_t)chunk_size > len) chunk_size = (uint32_t)(len - pos - 8);

        if (std::memcmp(chunk_id, "fmt ", 4) == 0 && chunk_size >= 16) {
            std::memcpy(&audio_format, body, 2);
            std::memcpy(&num_channels, body + 2, 2);
            std::memcpy(&rate, body + 4, 4);
            std::memcpy(&bits, body + 14, 2);
            if (audio_format == (int16_t)0xFFFE && chunk_size >= 40) {
                // WAVE_FORMAT_EXTENSIBLE: true format lives in the GUID.
                std::memcpy(&audio_format, body + 24, 2);
            }
        } else if (std::memcmp(chunk_id, "data", 4) == 0) {
            pcm = body;
            pcm_len = chunk_size;
        }
        pos += 8 + chunk_size + (chunk_size & 1);  // chunks are word-aligned
    }

    if (!pcm || num_channels <= 0 || rate <= 0) return -2;
    const int bytes_per_sample = bits / 8;
    if (bytes_per_sample <= 0) return -3;
    const int64_t total_samples = pcm_len / bytes_per_sample;
    const int64_t n_frames = total_samples / num_channels;

    *sample_rate = rate;
    *channels = num_channels;
    *frames = n_frames;
    if (out == nullptr) return 0;  // metadata-only query
    if (out_capacity < n_frames * num_channels) return -4;

    if (audio_format == 1 && bits == 16) {
        const int16_t* src = reinterpret_cast<const int16_t*>(pcm);
        const float scale = 1.0f / 32768.0f;
        for (int64_t i = 0; i < total_samples; ++i) out[i] = src[i] * scale;
    } else if (audio_format == 1 && bits == 32) {
        const int32_t* src = reinterpret_cast<const int32_t*>(pcm);
        const float scale = 1.0f / 2147483648.0f;
        for (int64_t i = 0; i < total_samples; ++i) out[i] = src[i] * scale;
    } else if (audio_format == 1 && bits == 24) {
        const float scale = 1.0f / 8388608.0f;
        for (int64_t i = 0; i < total_samples; ++i) {
            const uint8_t* p = pcm + 3 * i;
            int32_t v = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16));
            if (v & 0x800000) v |= ~0xFFFFFF;  // sign-extend
            out[i] = v * scale;
        }
    } else if (audio_format == 3 && bits == 32) {
        std::memcpy(out, pcm, total_samples * sizeof(float));
    } else {
        return -5;  // unsupported encoding
    }
    return 0;
}

// Average interleaved channels into mono.
void avex_mix_to_mono(const float* in, int64_t frames, int32_t channels, float* out) {
    if (channels == 1) { std::memcpy(out, in, frames * sizeof(float)); return; }
    const float inv = 1.0f / channels;
    for (int64_t f = 0; f < frames; ++f) {
        float acc = 0.0f;
        for (int32_t c = 0; c < channels; ++c) acc += in[f * channels + c];
        out[f] = acc * inv;
    }
}

// Windowed-sinc (Hann, `taps` half-width) resampler, mono float32.
// n_out should be floor(n_in * sr_out / sr_in).
void avex_resample(const float* in, int64_t n_in, int32_t sr_in,
                   float* out, int64_t n_out, int32_t sr_out, int32_t taps) {
    if (sr_in == sr_out) {
        std::memcpy(out, in, std::min(n_in, n_out) * sizeof(float));
        return;
    }
    const double ratio = (double)sr_in / (double)sr_out;
    // Low-pass at the lower Nyquist when downsampling.
    const double cutoff = ratio > 1.0 ? 1.0 / ratio : 1.0;
    const double support = taps;
    for (int64_t i = 0; i < n_out; ++i) {
        const double center = i * ratio;
        const int64_t lo = std::max<int64_t>(0, (int64_t)std::ceil(center - support / cutoff));
        const int64_t hi = std::min<int64_t>(n_in - 1, (int64_t)std::floor(center + support / cutoff));
        double acc = 0.0, wsum = 0.0;
        for (int64_t j = lo; j <= hi; ++j) {
            const double x = (j - center) * cutoff;
            double w;
            if (std::fabs(x) < 1e-9) {
                w = 1.0;
            } else if (std::fabs(x) >= support) {
                continue;
            } else {
                const double px = M_PI * x;
                const double sinc = std::sin(px) / px;
                const double hann = 0.5 + 0.5 * std::cos(px / support);
                w = sinc * hann;
            }
            acc += in[j] * w;
            wsum += w;
        }
        out[i] = wsum > 1e-12 ? (float)(acc / wsum) : 0.0f;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// FLAC decoder (decode-only, dependency-free).
//
// The reference reads FLAC through soundfile/libsndfile; this is the
// avex-tpu native equivalent. Correctness is self-verified: FLAC's
// STREAMINFO block stores the MD5 of the unencoded audio, which the decoder
// recomputes over its own output (md5_status: 1 = verified, -1 = MISMATCH,
// 0 = no signature in the file).
// ---------------------------------------------------------------------------

namespace avexflac {

// --- minimal MD5 (RFC 1321) for the STREAMINFO signature check -------------
struct MD5 {
    uint32_t a = 0x67452301, b = 0xefcdab89, c = 0x98badcfe, d = 0x10325476;
    uint64_t total = 0;
    uint8_t buf[64];
    int buf_len = 0;

    static uint32_t rotl(uint32_t x, int s) { return (x << s) | (x >> (32 - s)); }

    void block(const uint8_t* p) {
        static const uint32_t K[64] = {
            0xd76aa478,0xe8c7b756,0x242070db,0xc1bdceee,0xf57c0faf,0x4787c62a,
            0xa8304613,0xfd469501,0x698098d8,0x8b44f7af,0xffff5bb1,0x895cd7be,
            0x6b901122,0xfd987193,0xa679438e,0x49b40821,0xf61e2562,0xc040b340,
            0x265e5a51,0xe9b6c7aa,0xd62f105d,0x02441453,0xd8a1e681,0xe7d3fbc8,
            0x21e1cde6,0xc33707d6,0xf4d50d87,0x455a14ed,0xa9e3e905,0xfcefa3f8,
            0x676f02d9,0x8d2a4c8a,0xfffa3942,0x8771f681,0x6d9d6122,0xfde5380c,
            0xa4beea44,0x4bdecfa9,0xf6bb4b60,0xbebfbc70,0x289b7ec6,0xeaa127fa,
            0xd4ef3085,0x04881d05,0xd9d4d039,0xe6db99e5,0x1fa27cf8,0xc4ac5665,
            0xf4292244,0x432aff97,0xab9423a7,0xfc93a039,0x655b59c3,0x8f0ccc92,
            0xffeff47d,0x85845dd1,0x6fa87e4f,0xfe2ce6e0,0xa3014314,0x4e0811a1,
            0xf7537e82,0xbd3af235,0x2ad7d2bb,0xeb86d391};
        static const int S[64] = {
            7,12,17,22,7,12,17,22,7,12,17,22,7,12,17,22,
            5,9,14,20,5,9,14,20,5,9,14,20,5,9,14,20,
            4,11,16,23,4,11,16,23,4,11,16,23,4,11,16,23,
            6,10,15,21,6,10,15,21,6,10,15,21,6,10,15,21};
        uint32_t m[16];
        for (int i = 0; i < 16; ++i)
            m[i] = (uint32_t)p[4*i] | ((uint32_t)p[4*i+1] << 8) |
                   ((uint32_t)p[4*i+2] << 16) | ((uint32_t)p[4*i+3] << 24);
        uint32_t A = a, B = b, C = c, D = d;
        for (int i = 0; i < 64; ++i) {
            uint32_t f; int g;
            if (i < 16)      { f = (B & C) | (~B & D);        g = i; }
            else if (i < 32) { f = (D & B) | (~D & C);        g = (5*i + 1) & 15; }
            else if (i < 48) { f = B ^ C ^ D;                 g = (3*i + 5) & 15; }
            else             { f = C ^ (B | ~D);              g = (7*i) & 15; }
            uint32_t tmp = D;
            D = C; C = B;
            B = B + rotl(A + f + K[i] + m[g], S[i]);
            A = tmp;
        }
        a += A; b += B; c += C; d += D;
    }

    void update(const uint8_t* p, int64_t n) {
        total += (uint64_t)n;
        while (n > 0) {
            int take = (int)std::min<int64_t>(n, 64 - buf_len);
            std::memcpy(buf + buf_len, p, take);
            buf_len += take; p += take; n -= take;
            if (buf_len == 64) { block(buf); buf_len = 0; }
        }
    }

    void finish(uint8_t digest[16]) {
        uint64_t bits = total * 8;
        uint8_t pad = 0x80;
        update(&pad, 1);
        uint8_t zero = 0;
        while (buf_len != 56) update(&zero, 1);
        uint8_t lenb[8];
        for (int i = 0; i < 8; ++i) lenb[i] = (uint8_t)(bits >> (8 * i));
        update(lenb, 8);
        uint32_t vals[4] = {a, b, c, d};
        for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 4; ++j) digest[4*i + j] = (uint8_t)(vals[i] >> (8*j));
    }
};

// --- MSB-first bit reader ---------------------------------------------------
struct BitReader {
    const uint8_t* data;
    int64_t len;
    int64_t byte_pos = 0;
    int bit_pos = 0;  // bits consumed of current byte
    bool error = false;

    BitReader(const uint8_t* d, int64_t l) : data(d), len(l) {}

    bool eof() const { return byte_pos >= len; }

    uint32_t read_bits(int n) {  // n <= 32
        uint32_t v = 0;
        while (n > 0) {
            if (byte_pos >= len) { error = true; return 0; }
            int avail = 8 - bit_pos;
            int take = n < avail ? n : avail;
            uint32_t chunk = (uint32_t)(data[byte_pos] >> (avail - take)) & ((1u << take) - 1);
            v = (v << take) | chunk;
            bit_pos += take;
            n -= take;
            if (bit_pos == 8) { bit_pos = 0; ++byte_pos; }
        }
        return v;
    }

    uint64_t read_bits64(int n) {
        if (n <= 32) return read_bits(n);
        uint64_t hi = read_bits(n - 32);
        return (hi << 32) | read_bits(32);
    }

    int32_t read_signed(int n) {
        uint32_t v = read_bits(n);
        if (n < 32 && (v & (1u << (n - 1)))) v |= ~((1u << n) - 1);
        return (int32_t)v;
    }

    uint32_t read_unary() {
        uint32_t q = 0;
        while (!error && read_bits(1) == 0) {
            ++q;
            if (q > 1u << 24) { error = true; return 0; }  // corrupt stream guard
        }
        return q;
    }

    void align_byte() { if (bit_pos) { bit_pos = 0; ++byte_pos; } }

    // UTF-8-style coded number in frame headers (up to 36 bits).
    uint64_t read_coded_number() {
        uint32_t head = read_bits(8);
        int extra = 0;
        uint64_t v = 0;
        if (head < 0x80) return head;
        else if ((head & 0xE0) == 0xC0) { v = head & 0x1F; extra = 1; }
        else if ((head & 0xF0) == 0xE0) { v = head & 0x0F; extra = 2; }
        else if ((head & 0xF8) == 0xF0) { v = head & 0x07; extra = 3; }
        else if ((head & 0xFC) == 0xF8) { v = head & 0x03; extra = 4; }
        else if ((head & 0xFE) == 0xFC) { v = head & 0x01; extra = 5; }
        else if (head == 0xFE) { v = 0; extra = 6; }
        else { error = true; return 0; }
        for (int i = 0; i < extra; ++i) v = (v << 6) | (read_bits(8) & 0x3F);
        return v;
    }
};

static const int32_t kBlockSizes[16] = {
    0, 192, 576, 1152, 2304, 4608, -1, -2,  // -1: 8-bit follows, -2: 16-bit follows
    256, 512, 1024, 2048, 4096, 8192, 16384, 32768};

static const int kSampleSizes[8] = {0, 8, 12, -1, 16, 20, 24, 32};

// Decode one subframe into samples[] (int32, before channel decorrelation).
static bool decode_subframe(BitReader& br, int32_t* samples, int block_size, int bps) {
    if (br.read_bits(1) != 0) return false;  // padding bit
    uint32_t type = br.read_bits(6);
    int wasted = 0;
    if (br.read_bits(1)) wasted = 1 + (int)br.read_unary();
    bps -= wasted;

    int order = 0;
    bool is_fixed = false, is_lpc = false;
    if (type == 0) {  // CONSTANT
        int32_t v = br.read_signed(bps);
        for (int i = 0; i < block_size; ++i) samples[i] = v;
    } else if (type == 1) {  // VERBATIM
        for (int i = 0; i < block_size; ++i) samples[i] = br.read_signed(bps);
    } else if (type >= 8 && type <= 12) {
        is_fixed = true; order = (int)type - 8;
    } else if (type >= 32) {
        is_lpc = true; order = (int)(type & 0x1F) + 1;
    } else {
        return false;
    }

    int32_t qlp_coefs[32];
    int qlp_shift = 0;
    if (is_fixed || is_lpc) {
        for (int i = 0; i < order; ++i) samples[i] = br.read_signed(bps);  // warmup
        if (is_lpc) {
            int precision = (int)br.read_bits(4);
            if (precision == 15) return false;
            precision += 1;
            qlp_shift = br.read_signed(5);
            if (qlp_shift < 0) return false;
            for (int i = 0; i < order; ++i) qlp_coefs[i] = br.read_signed(precision);
        }

        // Residual: rice-coded partitions.
        uint32_t method = br.read_bits(2);
        if (method > 1) return false;
        int param_bits = method == 0 ? 4 : 5;
        uint32_t escape = method == 0 ? 15 : 31;
        int porder = (int)br.read_bits(4);
        int partitions = 1 << porder;
        if (block_size % partitions) return false;
        int idx = order;
        for (int p = 0; p < partitions; ++p) {
            int count = (block_size >> porder) - (p == 0 ? order : 0);
            if (count < 0) return false;
            uint32_t param = br.read_bits(param_bits);
            if (param == escape) {
                int raw_bits = (int)br.read_bits(5);
                for (int i = 0; i < count; ++i)
                    samples[idx++] = raw_bits ? br.read_signed(raw_bits) : 0;
            } else {
                for (int i = 0; i < count; ++i) {
                    uint32_t q = br.read_unary();
                    uint32_t r = param ? br.read_bits((int)param) : 0;
                    uint32_t u = (q << param) | r;
                    samples[idx++] = (int32_t)(u >> 1) ^ -(int32_t)(u & 1);
                }
            }
            if (br.error) return false;
        }

        // Prediction.
        if (is_fixed) {
            switch (order) {
                case 0: break;
                case 1: for (int i = 1; i < block_size; ++i) samples[i] += samples[i-1]; break;
                case 2: for (int i = 2; i < block_size; ++i)
                            samples[i] += 2*samples[i-1] - samples[i-2]; break;
                case 3: for (int i = 3; i < block_size; ++i)
                            samples[i] += 3*samples[i-1] - 3*samples[i-2] + samples[i-3]; break;
                case 4: for (int i = 4; i < block_size; ++i)
                            samples[i] += 4*samples[i-1] - 6*samples[i-2] + 4*samples[i-3] - samples[i-4]; break;
                default: return false;
            }
        } else {
            for (int i = order; i < block_size; ++i) {
                int64_t acc = 0;
                for (int j = 0; j < order; ++j)
                    acc += (int64_t)qlp_coefs[j] * (int64_t)samples[i - 1 - j];
                samples[i] += (int32_t)(acc >> qlp_shift);
            }
        }
    }

    if (wasted)
        for (int i = 0; i < block_size; ++i) samples[i] <<= wasted;
    return !br.error;
}

}  // namespace avexflac

extern "C" {

// Decode a FLAC buffer. Same two-pass contract as avex_decode_wav; on the
// fill pass `md5_status` reports the STREAMINFO signature check
// (1 verified / -1 mismatch / 0 no signature).
int avex_decode_flac(const uint8_t* data, int64_t len,
                     float* out, int64_t out_capacity,
                     int32_t* sample_rate, int32_t* channels, int64_t* frames,
                     int32_t* md5_status) {
    using namespace avexflac;
    if (md5_status) *md5_status = 0;
    if (len < 42 || std::memcmp(data, "fLaC", 4) != 0) return -1;

    // --- metadata blocks ---
    int64_t pos = 4;
    int32_t rate = 0, nch = 0, bps = 0;
    int64_t total_samples = 0;
    uint8_t md5_sig[16] = {0};
    bool have_streaminfo = false;
    bool last = false;
    while (!last && pos + 4 <= len) {
        uint8_t head = data[pos];
        last = head & 0x80;
        int type = head & 0x7F;
        uint32_t size = ((uint32_t)data[pos+1] << 16) | ((uint32_t)data[pos+2] << 8) | data[pos+3];
        pos += 4;
        if (pos + size > len) return -2;
        if (type == 0 && size >= 34) {  // STREAMINFO
            const uint8_t* p = data + pos;
            rate = ((int32_t)p[10] << 12) | ((int32_t)p[11] << 4) | (p[12] >> 4);
            nch = ((p[12] >> 1) & 0x7) + 1;
            bps = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
            total_samples = ((int64_t)(p[13] & 0x0F) << 32) | ((int64_t)p[14] << 24) |
                            ((int64_t)p[15] << 16) | ((int64_t)p[16] << 8) | p[17];
            std::memcpy(md5_sig, p + 18, 16);
            have_streaminfo = true;
        }
        pos += size;
    }
    if (!have_streaminfo || rate <= 0 || nch <= 0) return -3;

    *sample_rate = rate;
    *channels = nch;
    *frames = total_samples;
    if (out == nullptr && total_samples > 0) return 0;  // metadata-only query

    // --- frames ---
    bool want_md5 = false;
    for (int i = 0; i < 16; ++i) want_md5 |= md5_sig[i] != 0;
    MD5 md5;
    const int bytes_per_sample = (bps + 7) / 8;
    uint8_t md5_buf[8];

    BitReader br(data, len);
    br.byte_pos = pos;
    // Heap-allocated per-channel workspace (2 MB on the stack would be unsafe
    // under the multi-worker loader's threads).
    std::vector<std::vector<int32_t>> ch_storage(8, std::vector<int32_t>(65536));
    int32_t* ch_buf[8];
    for (int c = 0; c < 8; ++c) ch_buf[c] = ch_storage[c].data();
    int64_t written = 0;
    const float scale = 1.0f / (float)(1u << (bps - 1));

    while (br.byte_pos < len && (total_samples == 0 || written < total_samples)) {
        // Frame header.
        if (br.read_bits(14) != 0x3FFE) return -5;
        br.read_bits(1);  // reserved
        br.read_bits(1);  // blocking strategy
        uint32_t bs_code = br.read_bits(4);
        uint32_t sr_code = br.read_bits(4);
        uint32_t ch_code = br.read_bits(4);
        uint32_t ss_code = br.read_bits(3);
        br.read_bits(1);  // reserved
        br.read_coded_number();

        int32_t block_size = kBlockSizes[bs_code];
        if (block_size == -1) block_size = (int32_t)br.read_bits(8) + 1;
        else if (block_size == -2) block_size = (int32_t)br.read_bits(16) + 1;
        else if (block_size == 0) return -6;
        if (sr_code == 12) br.read_bits(8);
        else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
        int frame_bps = kSampleSizes[ss_code];
        if (frame_bps == 0) frame_bps = bps;
        if (frame_bps <= 0) return -7;
        br.read_bits(8);  // CRC-8 (unchecked; MD5 verifies the payload)
        if (br.error || block_size > 65536) return -8;

        int n_sub = nch;
        int side_channel = -1;  // which subframe carries the +1-bit side signal
        if (ch_code >= 8 && ch_code <= 10) {
            n_sub = 2;
            side_channel = (ch_code == 9) ? 0 : 1;
        } else {
            n_sub = (int)ch_code + 1;
            if (n_sub != nch) return -9;
        }

        for (int c = 0; c < n_sub; ++c) {
            int sub_bps = frame_bps + (c == side_channel ? 1 : 0);
            if (!decode_subframe(br, ch_buf[c], block_size, sub_bps)) return -10;
        }
        br.align_byte();
        br.read_bits(16);  // frame CRC-16 (unchecked)
        if (br.error) return -11;

        // Channel decorrelation.
        if (ch_code == 8) {         // left/side -> right = left - side
            for (int i = 0; i < block_size; ++i) ch_buf[1][i] = ch_buf[0][i] - ch_buf[1][i];
        } else if (ch_code == 9) {  // side/right -> left = right + side
            for (int i = 0; i < block_size; ++i) ch_buf[0][i] = ch_buf[1][i] + ch_buf[0][i];
        } else if (ch_code == 10) { // mid/side
            for (int i = 0; i < block_size; ++i) {
                int32_t mid = ch_buf[0][i], side = ch_buf[1][i];
                mid = (mid << 1) | (side & 1);
                ch_buf[0][i] = (mid + side) >> 1;
                ch_buf[1][i] = (mid - side) >> 1;
            }
        }

        int64_t emit = block_size;
        if (total_samples > 0 && written + emit > total_samples)
            emit = total_samples - written;
        if (out != nullptr) {
            if ((written + emit) * nch > out_capacity) return -12;
            for (int64_t i = 0; i < emit; ++i)
                for (int c = 0; c < nch; ++c)
                    out[(written + i) * nch + c] = ch_buf[c][i] * scale;
        }
        if (want_md5) {
            for (int64_t i = 0; i < emit; ++i)
                for (int c = 0; c < nch; ++c) {
                    int32_t v = ch_buf[c][i];
                    for (int byte = 0; byte < bytes_per_sample; ++byte)
                        md5_buf[byte] = (uint8_t)(v >> (8 * byte));
                    md5.update(md5_buf, bytes_per_sample);
                }
        }
        written += emit;
        if (total_samples == 0) *frames = written;

        // Tolerate trailing garbage/padding after the last expected frame.
        if (total_samples > 0 && written >= total_samples) break;
        if (br.byte_pos >= len) break;
    }

    if (total_samples == 0) *frames = written;
    else if (written < total_samples) return -13;

    if (md5_status && want_md5 && out != nullptr) {
        uint8_t digest[16];
        md5.finish(digest);
        *md5_status = std::memcmp(digest, md5_sig, 16) == 0 ? 1 : -1;
    }
    return 0;
}

}  // extern "C"
