// stratum_audio: native audio decode + batch loading runtime.
//
// Batch-pipeline replacement for the reference's host-side decode layer
// (symphonia in examples/analyze_file.rs:25-180 and the rayon batch pool in
// examples/analyze_batch.rs:239-262): a C++ library that decodes WAV (own
// RIFF parser, all common sample formats), FLAC (own from-scratch decoder,
// flac_decoder.cpp), MP3 (libmpg123, dlopen'd so a missing lib degrades
// gracefully), OGG Vorbis (libvorbisfile, dlopen'd) and m4a/AAC + any other
// ffmpeg-supported container (libavformat/avcodec, dlopen'd,
// ffmpeg_decoder.cpp), mixes to mono, optionally resamples, and runs a
// std::thread decode pool for batches. Exposed as a C API consumed by
// Python via ctypes (stratum_dsp_tpu/io/decode.py).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libstratum_audio.so \
//            stratum_audio.cpp flac_decoder.cpp ffmpeg_decoder.cpp \
//            -ldl -lpthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// flac_decoder.cpp
int flac_decode_buffer(const uint8_t* buf, size_t size,
                       std::vector<float>* interleaved, int* channels_out,
                       int* sample_rate_out);

// ffmpeg_decoder.cpp (dlopen'd libavformat/avcodec: m4a/AAC + universal
// fallback, analogue of symphonia's format coverage in analyze_file.rs:25-180)
bool ffmpeg_available();
int ffmpeg_decode_file(const char* path, std::vector<float>* interleaved,
                       int* channels_out, int* sample_rate_out);
int ffmpeg_encode_audio(const char* path, const char* codec_name,
                        const float* mono, int64_t n, int sample_rate);
int ffmpeg_encode_m4a(const char* path, const float* mono, int64_t n,
                      int sample_rate);

namespace {

enum MixMode {
  MIX_AVERAGE = 0,   // (L+R)/2 — reference Mono/MidSide/Center
  MIX_DOMINANT = 1,  // louder channel per sample — reference Dominant
};

enum SaError {
  SA_OK = 0,
  SA_ERR_OPEN = 1,
  SA_ERR_FORMAT = 2,
  SA_ERR_UNSUPPORTED = 3,
  SA_ERR_ALLOC = 4,
  SA_ERR_MP3_UNAVAILABLE = 5,
  SA_ERR_OGG_UNAVAILABLE = 6,
  SA_ERR_FFMPEG_UNAVAILABLE = 7,
};

struct Decoded {
  std::vector<float> mono;
  int sample_rate = 0;
};

// ---------------------------------------------------------------------------
// Mixdown
// ---------------------------------------------------------------------------

void mix_to_mono(const float* interleaved, int64_t frames, int channels,
                 int mix_mode, std::vector<float>& out) {
  out.resize(frames);
  if (channels == 1) {
    std::memcpy(out.data(), interleaved, frames * sizeof(float));
    return;
  }
  if (mix_mode == MIX_DOMINANT && channels == 2) {
    for (int64_t i = 0; i < frames; i++) {
      float l = interleaved[2 * i], r = interleaved[2 * i + 1];
      out[i] = (std::abs(l) >= std::abs(r)) ? l : r;
    }
    return;
  }
  for (int64_t i = 0; i < frames; i++) {
    float acc = 0.f;
    for (int c = 0; c < channels; c++) acc += interleaved[i * channels + c];
    out[i] = acc / channels;
  }
}

// ---------------------------------------------------------------------------
// Linear resampler (analysis-grade; tracks are usually already 44.1 kHz)
// ---------------------------------------------------------------------------

void resample_linear(const std::vector<float>& in, int sr_in, int sr_out,
                     std::vector<float>& out) {
  if (sr_in == sr_out || in.empty()) {
    out = in;
    return;
  }
  const double ratio = static_cast<double>(sr_in) / sr_out;
  const int64_t n_out = static_cast<int64_t>(in.size() / ratio);
  out.resize(n_out);
  for (int64_t i = 0; i < n_out; i++) {
    double pos = i * ratio;
    int64_t i0 = static_cast<int64_t>(pos);
    int64_t i1 = std::min<int64_t>(i0 + 1, in.size() - 1);
    double frac = pos - i0;
    out[i] = static_cast<float>(in[i0] * (1.0 - frac) + in[i1] * frac);
  }
}

// ---------------------------------------------------------------------------
// WAV (RIFF) parser — PCM u8/s16/s24/s32, IEEE f32/f64, EXTENSIBLE
// ---------------------------------------------------------------------------

uint32_t rd_u32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}
uint16_t rd_u16(const uint8_t* p) { return p[0] | (p[1] << 8); }

int decode_wav(const char* path, int mix_mode, Decoded& dec) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return SA_ERR_OPEN;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return SA_ERR_OPEN;
  }
  std::fclose(f);

  if (size < 44 || std::memcmp(buf.data(), "RIFF", 4) ||
      std::memcmp(buf.data() + 8, "WAVE", 4))
    return SA_ERR_FORMAT;

  uint16_t fmt_tag = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* data = nullptr;
  uint64_t data_len = 0;

  uint64_t off = 12;
  while (off + 8 <= static_cast<uint64_t>(size)) {
    const uint8_t* ch = buf.data() + off;
    uint32_t chunk_len = rd_u32(ch + 4);
    const uint8_t* body = ch + 8;
    if (!std::memcmp(ch, "fmt ", 4) && chunk_len >= 16) {
      fmt_tag = rd_u16(body);
      channels = rd_u16(body + 2);
      sr = rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt_tag == 0xFFFE && chunk_len >= 40) {
        fmt_tag = rd_u16(body + 24);  // sub-format GUID first two bytes
      }
    } else if (!std::memcmp(ch, "data", 4)) {
      data = body;
      data_len = std::min<uint64_t>(chunk_len, size - (off + 8));
    }
    off += 8 + chunk_len + (chunk_len & 1);
  }
  if (!data || !channels || !sr) return SA_ERR_FORMAT;

  int bytes = bits / 8;
  if (bytes == 0) return SA_ERR_FORMAT;
  int64_t frames = data_len / (bytes * channels);
  std::vector<float> interleaved(frames * channels);

  const bool is_float = (fmt_tag == 3);
  for (int64_t i = 0; i < frames * channels; i++) {
    const uint8_t* p = data + i * bytes;
    float v = 0.f;
    if (is_float && bits == 32) {
      std::memcpy(&v, p, 4);
    } else if (is_float && bits == 64) {
      double d;
      std::memcpy(&d, p, 8);
      v = static_cast<float>(d);
    } else if (bits == 8) {
      v = (static_cast<int>(p[0]) - 128) / 128.0f;
    } else if (bits == 16) {
      int16_t s = static_cast<int16_t>(rd_u16(p));
      v = s / 32768.0f;
    } else if (bits == 24) {
      int32_t s = (p[0] << 8) | (p[1] << 16) | (uint32_t(p[2]) << 24);
      v = (s >> 8) / 8388608.0f;
    } else if (bits == 32) {
      int32_t s = static_cast<int32_t>(rd_u32(p));
      v = s / 2147483648.0f;
    } else {
      return SA_ERR_UNSUPPORTED;
    }
    interleaved[i] = v;
  }

  mix_to_mono(interleaved.data(), frames, channels, mix_mode, dec.mono);
  dec.sample_rate = sr;
  return SA_OK;
}

// ---------------------------------------------------------------------------
// MP3 via libmpg123 (dlopen)
// ---------------------------------------------------------------------------

struct Mpg123Api {
  void* lib = nullptr;
  int (*init)() = nullptr;
  void* (*new_)(const char*, int*) = nullptr;
  void (*delete_)(void*) = nullptr;
  int (*open)(void*, const char*) = nullptr;
  int (*close)(void*) = nullptr;
  int (*getformat)(void*, long*, int*, int*) = nullptr;
  int (*format_none)(void*) = nullptr;
  int (*format)(void*, long, int, int) = nullptr;
  int (*read)(void*, unsigned char*, size_t, size_t*) = nullptr;
  bool ok = false;
};

Mpg123Api& mpg123_api() {
  static Mpg123Api api;
  static std::once_flag once;
  std::call_once(once, [] {
    api.lib = dlopen("libmpg123.so.0", RTLD_NOW | RTLD_GLOBAL);
    if (!api.lib) api.lib = dlopen("libmpg123.so", RTLD_NOW | RTLD_GLOBAL);
    if (!api.lib) return;
    api.init = (int (*)())dlsym(api.lib, "mpg123_init");
    api.new_ = (void* (*)(const char*, int*))dlsym(api.lib, "mpg123_new");
    api.delete_ = (void (*)(void*))dlsym(api.lib, "mpg123_delete");
    api.open = (int (*)(void*, const char*))dlsym(api.lib, "mpg123_open");
    api.close = (int (*)(void*))dlsym(api.lib, "mpg123_close");
    api.getformat =
        (int (*)(void*, long*, int*, int*))dlsym(api.lib, "mpg123_getformat");
    api.format_none = (int (*)(void*))dlsym(api.lib, "mpg123_format_none");
    api.format = (int (*)(void*, long, int, int))dlsym(api.lib, "mpg123_format");
    api.read = (int (*)(void*, unsigned char*, size_t, size_t*))dlsym(api.lib,
                                                                      "mpg123_read");
    if (api.init && api.new_ && api.open && api.getformat && api.read) {
      api.init();
      api.ok = true;
    }
  });
  return api;
}

constexpr int MPG123_ENC_FLOAT_32 = 0x200;
constexpr int MPG123_OK = 0;
constexpr int MPG123_DONE = -12;
constexpr int MPG123_NEW_FORMAT = -11;

int decode_mp3(const char* path, int mix_mode, Decoded& dec) {
  Mpg123Api& api = mpg123_api();
  if (!api.ok) return SA_ERR_MP3_UNAVAILABLE;
  int err = 0;
  void* h = api.new_(nullptr, &err);
  if (!h) return SA_ERR_ALLOC;
  if (api.open(h, path) != MPG123_OK) {
    api.delete_(h);
    return SA_ERR_OPEN;
  }
  long rate;
  int channels, enc;
  api.getformat(h, &rate, &channels, &enc);
  api.format_none(h);
  api.format(h, rate, channels, MPG123_ENC_FLOAT_32);
  // re-open to apply the forced format from the start
  api.close(h);
  api.open(h, path);

  std::vector<float> interleaved;
  std::vector<unsigned char> chunk(1 << 18);
  size_t done = 0;
  int rc;
  // The first read after (re)open reports MPG123_NEW_FORMAT (with done==0)
  // before any audio; treat it as a format refresh, not an error, or every
  // real-world MP3 decodes to zero samples.
  while (true) {
    rc = api.read(h, chunk.data(), chunk.size(), &done);
    if (rc == MPG123_NEW_FORMAT) {
      int enc2 = 0;
      api.getformat(h, &rate, &channels, &enc2);
      continue;
    }
    if (rc != MPG123_OK && !(rc == MPG123_DONE && done > 0)) break;
    size_t n = done / sizeof(float);
    const float* p = reinterpret_cast<const float*>(chunk.data());
    interleaved.insert(interleaved.end(), p, p + n);
    if (rc == MPG123_DONE) break;
  }
  api.close(h);
  api.delete_(h);
  if (interleaved.empty()) return SA_ERR_FORMAT;

  mix_to_mono(interleaved.data(), interleaved.size() / channels, channels,
              mix_mode, dec.mono);
  dec.sample_rate = static_cast<int>(rate);
  return SA_OK;
}

// ---------------------------------------------------------------------------
// FLAC (own decoder, flac_decoder.cpp)
// ---------------------------------------------------------------------------

int decode_flac(const char* path, int mix_mode, Decoded& dec) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return SA_ERR_OPEN;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return SA_ERR_OPEN;
  }
  std::fclose(f);

  std::vector<float> interleaved;
  int channels = 0, sr = 0;
  int rc = flac_decode_buffer(buf.data(), buf.size(), &interleaved, &channels, &sr);
  if (rc != 0) return rc == 3 ? SA_ERR_UNSUPPORTED : SA_ERR_FORMAT;
  mix_to_mono(interleaved.data(),
              static_cast<int64_t>(interleaved.size() / channels), channels,
              mix_mode, dec.mono);
  dec.sample_rate = sr;
  return SA_OK;
}

// ---------------------------------------------------------------------------
// OGG Vorbis via libvorbisfile (dlopen)
// ---------------------------------------------------------------------------

struct OggVorbisFile {  // mirror of OggVorbis_File, opaque blob large enough
  unsigned char opaque[1024];
};
struct VorbisInfoMini {
  int version;
  int channels;
  long rate;
  // (trailing fields unused)
};

struct VorbisApi {
  void* lib = nullptr;
  int (*fopen)(const char*, OggVorbisFile*) = nullptr;
  VorbisInfoMini* (*info)(OggVorbisFile*, int) = nullptr;
  long (*read_float)(OggVorbisFile*, float***, int, int*) = nullptr;
  int (*clear)(OggVorbisFile*) = nullptr;
  bool ok = false;
};

VorbisApi& vorbis_api() {
  static VorbisApi api;
  static std::once_flag once;
  std::call_once(once, [] {
    api.lib = dlopen("libvorbisfile.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (!api.lib) api.lib = dlopen("libvorbisfile.so", RTLD_NOW | RTLD_GLOBAL);
    if (!api.lib) return;
    api.fopen = (int (*)(const char*, OggVorbisFile*))dlsym(api.lib, "ov_fopen");
    api.info = (VorbisInfoMini * (*)(OggVorbisFile*, int)) dlsym(api.lib, "ov_info");
    api.read_float =
        (long (*)(OggVorbisFile*, float***, int, int*))dlsym(api.lib, "ov_read_float");
    api.clear = (int (*)(OggVorbisFile*))dlsym(api.lib, "ov_clear");
    if (api.fopen && api.info && api.read_float && api.clear) api.ok = true;
  });
  return api;
}

int decode_ogg(const char* path, int mix_mode, Decoded& dec) {
  VorbisApi& api = vorbis_api();
  if (!api.ok) return SA_ERR_OGG_UNAVAILABLE;
  OggVorbisFile vf;
  std::memset(&vf, 0, sizeof(vf));
  if (api.fopen(path, &vf) != 0) return SA_ERR_FORMAT;
  VorbisInfoMini* vi = api.info(&vf, -1);
  if (!vi || vi->channels <= 0) {
    api.clear(&vf);
    return SA_ERR_FORMAT;
  }
  int channels = vi->channels;
  long rate = vi->rate;
  std::vector<float> interleaved;
  int bitstream = 0;
  for (;;) {
    float** pcm = nullptr;
    long n = api.read_float(&vf, &pcm, 4096, &bitstream);
    if (n <= 0) break;
    size_t base = interleaved.size();
    interleaved.resize(base + size_t(n) * channels);
    for (long i = 0; i < n; i++)
      for (int c = 0; c < channels; c++)
        interleaved[base + size_t(i) * channels + c] = pcm[c][i];
  }
  api.clear(&vf);
  if (interleaved.empty()) return SA_ERR_FORMAT;
  mix_to_mono(interleaved.data(),
              static_cast<int64_t>(interleaved.size() / channels), channels,
              mix_mode, dec.mono);
  dec.sample_rate = static_cast<int>(rate);
  return SA_OK;
}

int decode_ffmpeg(const char* path, int mix_mode, Decoded& dec) {
  std::vector<float> interleaved;
  int channels = 0, sr = 0;
  int rc = ffmpeg_decode_file(path, &interleaved, &channels, &sr);
  if (rc != 0) {
    if (rc == 7) return SA_ERR_FFMPEG_UNAVAILABLE;
    return rc == 3 ? SA_ERR_UNSUPPORTED : (rc == 1 ? SA_ERR_OPEN : SA_ERR_FORMAT);
  }
  mix_to_mono(interleaved.data(),
              static_cast<int64_t>(interleaved.size() / channels), channels,
              mix_mode, dec.mono);
  dec.sample_rate = sr;
  return SA_OK;
}

int decode_any(const char* path, int mix_mode, Decoded& dec) {
  const char* ext = std::strrchr(path, '.');
  if (ext && (!strcasecmp(ext, ".mp3"))) return decode_mp3(path, mix_mode, dec);
  if (ext && (!strcasecmp(ext, ".flac"))) return decode_flac(path, mix_mode, dec);
  if (ext && (!strcasecmp(ext, ".ogg"))) return decode_ogg(path, mix_mode, dec);
  if (ext && (!strcasecmp(ext, ".m4a") || !strcasecmp(ext, ".mp4") ||
              !strcasecmp(ext, ".aac") || !strcasecmp(ext, ".wma") ||
              !strcasecmp(ext, ".aif") || !strcasecmp(ext, ".aiff")))
    return decode_ffmpeg(path, mix_mode, dec);
  int rc = decode_wav(path, mix_mode, dec);
  if (rc == SA_ERR_FORMAT && ext && !strcasecmp(ext, ".wav")) return rc;
  if (rc != SA_OK) {
    // content sniffing for unknown/wrong extensions
    int rc2 = decode_flac(path, mix_mode, dec);
    if (rc2 == SA_OK) return SA_OK;
    rc2 = decode_ogg(path, mix_mode, dec);
    if (rc2 == SA_OK) return SA_OK;
    rc2 = decode_mp3(path, mix_mode, dec);
    if (rc2 == SA_OK) return SA_OK;
    rc2 = decode_ffmpeg(path, mix_mode, dec);  // universal last resort
    if (rc2 == SA_OK) return SA_OK;
  }
  return rc;
}

}  // namespace

extern "C" {

// Decode one file to mono f32. Caller frees *out with sa_free.
int sa_decode_file(const char* path, int target_sr, int mix_mode, float** out,
                   int64_t* n_samples, int* sample_rate) {
  Decoded dec;
  int rc = decode_any(path, mix_mode, dec);
  if (rc != SA_OK) return rc;
  std::vector<float> final_samples;
  if (target_sr > 0 && target_sr != dec.sample_rate) {
    resample_linear(dec.mono, dec.sample_rate, target_sr, final_samples);
    dec.sample_rate = target_sr;
  } else {
    final_samples = std::move(dec.mono);
  }
  float* mem = static_cast<float*>(std::malloc(final_samples.size() * sizeof(float)));
  if (!mem) return SA_ERR_ALLOC;
  std::memcpy(mem, final_samples.data(), final_samples.size() * sizeof(float));
  *out = mem;
  *n_samples = static_cast<int64_t>(final_samples.size());
  *sample_rate = dec.sample_rate;
  return SA_OK;
}

void sa_free(float* p) { std::free(p); }

// Threaded batch decode (the reference's rayon pool analogue,
// analyze_batch.rs:239-262). outs/lens/srs/errs are caller-allocated arrays
// of length n; each successful outs[i] must be sa_free'd.
void sa_decode_batch(const char** paths, int n, int target_sr, int mix_mode,
                     int n_threads, float** outs, int64_t* lens, int* srs,
                     int* errs) {
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency() - 1);
  std::atomic<int> next(0);
  auto worker = [&] {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      outs[i] = nullptr;
      lens[i] = 0;
      srs[i] = 0;
      errs[i] = sa_decode_file(paths[i], target_sr, mix_mode, &outs[i], &lens[i],
                               &srs[i]);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < std::min(n_threads, n); t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

int sa_mp3_available() { return mpg123_api().ok ? 1 : 0; }

int sa_ogg_available() { return vorbis_api().ok ? 1 : 0; }

int sa_ffmpeg_available() { return ffmpeg_available() ? 1 : 0; }

// Test-fixture tool: encode mono f32 -> AAC/m4a (the analysis framework
// never encodes; this exists so test assets can be produced hermetically).
int sa_encode_m4a(const char* path, const float* mono, int64_t n,
                  int sample_rate) {
  return ffmpeg_encode_m4a(path, mono, n, sample_rate);
}

// Generalized fixture encoder: codec by avcodec name ("libmp3lame",
// "libvorbis", "aac", ...; container inferred from the path). Powers the
// lossy-codec battery families.
int sa_encode_audio(const char* path, const char* codec_name,
                    const float* mono, int64_t n, int sample_rate) {
  return ffmpeg_encode_audio(path, codec_name, mono, n, sample_rate);
}

}  // extern "C"
