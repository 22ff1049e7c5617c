// Native audio runtime for the PyTorch port: WAV decode, resample, RMS frames.
//
// The reference inherits its native IO from dependency wheels (libsndfile,
// numpy); this library is the framework's first-party equivalent: a
// zero-dependency RIFF/WAVE decoder with mono downmix, a linear-interp
// resampler, and the frame-RMS scan used by long-form split-point search.
// Exposed through a minimal C ABI consumed via ctypes (audio/native.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

constexpr uint16_t kFormatPcm = 1;
constexpr uint16_t kFormatFloat = 3;
constexpr uint16_t kFormatExtensible = 0xFFFE;

struct WavInfo {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint32_t rate = 0;
  uint16_t bits = 0;
  long data_offset = -1;
  uint32_t data_size = 0;
};

uint32_t read_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

uint16_t read_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// Parse chunk headers; returns false on malformed input.
bool parse_header(FILE* f, WavInfo* info) {
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return false;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0) return false;

  uint8_t chunk[8];
  while (fread(chunk, 1, 8, f) == 8) {
    const uint32_t size = read_u32(chunk + 4);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      std::vector<uint8_t> body(size);
      if (fread(body.data(), 1, size, f) != size) return false;
      if (size < 16) return false;
      info->format = read_u16(body.data());
      info->channels = read_u16(body.data() + 2);
      info->rate = read_u32(body.data() + 4);
      info->bits = read_u16(body.data() + 14);
      if (info->format == kFormatExtensible && size >= 26) {
        info->format = read_u16(body.data() + 24);  // SubFormat GUID head
      }
      if (size & 1) fseek(f, 1, SEEK_CUR);
    } else if (memcmp(chunk, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_size = size;
      fseek(f, static_cast<long>(size + (size & 1)), SEEK_CUR);
    } else {
      fseek(f, static_cast<long>(size + (size & 1)), SEEK_CUR);
    }
  }
  return info->data_offset >= 0 && info->format != 0;
}

}  // namespace

extern "C" {

// Decode a WAV file to mono float32.  Two-phase: call with out=nullptr to
// get the mono sample count, then with a buffer of that capacity.
// Returns the mono sample count, or a negative error code.
int64_t qa_decode_wav(const char* path, float* out, int64_t capacity,
                      int32_t* rate_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -2;
  }
  const bool pcm16 = info.format == kFormatPcm && info.bits == 16;
  const bool pcm32 = info.format == kFormatPcm && info.bits == 32;
  const bool f32 = info.format == kFormatFloat && info.bits == 32;
  if (!pcm16 && !pcm32 && !f32) {
    fclose(f);
    return -3;
  }
  if (info.channels == 0) {
    fclose(f);
    return -4;
  }

  const int64_t bytes_per_sample = info.bits / 8;
  const int64_t n_interleaved = info.data_size / bytes_per_sample;
  const int64_t n_mono = n_interleaved / info.channels;
  if (rate_out) *rate_out = static_cast<int32_t>(info.rate);
  if (out == nullptr) {
    fclose(f);
    return n_mono;
  }
  if (capacity < n_mono) {
    fclose(f);
    return -5;
  }

  fseek(f, info.data_offset, SEEK_SET);
  std::vector<uint8_t> raw(info.data_size);
  if (fread(raw.data(), 1, info.data_size, f) != info.data_size) {
    fclose(f);
    return -6;
  }
  fclose(f);

  const int ch = info.channels;
  const double inv_ch = 1.0 / ch;
  for (int64_t i = 0; i < n_mono; ++i) {
    double acc = 0.0;
    for (int c = 0; c < ch; ++c) {
      const uint8_t* p = raw.data() + (i * ch + c) * bytes_per_sample;
      if (pcm16) {
        int16_t v;
        memcpy(&v, p, 2);
        acc += v / 32768.0;
      } else if (pcm32) {
        int32_t v;
        memcpy(&v, p, 4);
        acc += v / 2147483648.0;
      } else {
        float v;
        memcpy(&v, p, 4);
        acc += v;
      }
    }
    out[i] = static_cast<float>(acc * inv_ch);
  }
  return n_mono;
}

// Linear-interpolation resample matching numpy.interp over
// linspace(0, n_in - 1, n_out).  Returns n_out.
int64_t qa_resample_linear(const float* in, int64_t n_in, float* out,
                           int64_t n_out) {
  if (n_in <= 0 || n_out <= 0) return 0;
  if (n_in == 1) {
    for (int64_t i = 0; i < n_out; ++i) out[i] = in[0];
    return n_out;
  }
  const double step = static_cast<double>(n_in - 1) / (n_out > 1 ? n_out - 1 : 1);
  for (int64_t i = 0; i < n_out; ++i) {
    const double pos = i * step;
    const int64_t lo = static_cast<int64_t>(pos);
    const int64_t hi = lo + 1 < n_in ? lo + 1 : n_in - 1;
    const double frac = pos - lo;
    out[i] = static_cast<float>(in[lo] * (1.0 - frac) + in[hi] * frac);
  }
  return n_out;
}

// Per-frame RMS over non-overlapping frames.  Returns the frame count.
int64_t qa_frame_rms(const float* samples, int64_t n, int64_t frame,
                     float* out) {
  if (frame <= 0) return 0;
  const int64_t n_frames = n / frame;
  for (int64_t i = 0; i < n_frames; ++i) {
    double acc = 0.0;
    const float* p = samples + i * frame;
    for (int64_t j = 0; j < frame; ++j) acc += static_cast<double>(p[j]) * p[j];
    out[i] = static_cast<float>(std::sqrt(acc / frame));
  }
  return n_frames;
}

}  // extern "C"
