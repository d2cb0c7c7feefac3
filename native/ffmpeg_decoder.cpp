// ffmpeg_decoder: dlopen'd libavformat/libavcodec/libavutil decode path.
//
// Covers the container/codec tail the bespoke decoders don't: m4a/AAC, mp4,
// wma, aiff, anything else ffmpeg knows — the batch pipeline's analogue of the
// reference's symphonia "decode any format" layer
// (/root/reference/examples/analyze_file.rs:25-180, which handles
// mp3/flac/wav/ogg/m4a and every sample format). Like the mpg123/vorbis
// paths, the libraries are dlopen'd so a missing ffmpeg degrades gracefully
// (sa_ffmpeg_available() == 0) instead of breaking the import.
//
// Types come from the system ffmpeg headers (lavf 59 / lavc 59 / lavu 57,
// ffmpeg 5.x); the dlopen targets pin the same major versions so struct
// layouts match. Without the headers the file compiles to stubs.
//
// Also exposes a minimal mono AAC/m4a encoder (ffmpeg_encode_m4a) used ONLY
// by the fixture generator: the environment has no other way to produce an
// .m4a test asset (no ffmpeg CLI, no pyav/torchaudio).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <dlfcn.h>
#include <mutex>
#include <vector>

#if defined(STRATUM_NO_FFMPEG) || !__has_include(<libavcodec/avcodec.h>)
// Built without the ffmpeg headers (a host with no libav*-dev; tests force
// it with -DSTRATUM_NO_FFMPEG): the library still loads, and the ffmpeg
// formats report "unavailable" (return 7) as they do when the shared
// libraries are missing at run time.
bool ffmpeg_available() { return false; }
int ffmpeg_decode_file(const char*, std::vector<float>*, int*, int*) { return 7; }
int ffmpeg_encode_audio(const char*, const char*, const float*, int64_t, int) { return 7; }
int ffmpeg_encode_m4a(const char*, const float*, int64_t, int) { return 7; }
#else

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/avutil.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
}

namespace {

struct FfApi {
  void* lavf = nullptr;
  void* lavc = nullptr;
  void* lavu = nullptr;
  bool ok = false;

  // libavformat
  int (*open_input)(AVFormatContext**, const char*, const AVInputFormat*,
                    AVDictionary**) = nullptr;
  void (*close_input)(AVFormatContext**) = nullptr;
  int (*find_stream_info)(AVFormatContext*, AVDictionary**) = nullptr;
  int (*find_best_stream)(AVFormatContext*, enum AVMediaType, int, int,
                          const AVCodec**, int) = nullptr;
  int (*read_frame)(AVFormatContext*, AVPacket*) = nullptr;
  int (*alloc_output_context2)(AVFormatContext**, const AVOutputFormat*,
                               const char*, const char*) = nullptr;
  void (*free_context)(AVFormatContext*) = nullptr;
  AVStream* (*new_stream)(AVFormatContext*, const AVCodec*) = nullptr;
  int (*write_header)(AVFormatContext*, AVDictionary**) = nullptr;
  int (*write_trailer)(AVFormatContext*) = nullptr;
  int (*interleaved_write_frame)(AVFormatContext*, AVPacket*) = nullptr;
  int (*avio_open_)(AVIOContext**, const char*, int) = nullptr;
  int (*avio_closep_)(AVIOContext**) = nullptr;

  // libavcodec
  const AVCodec* (*find_decoder)(enum AVCodecID) = nullptr;
  const AVCodec* (*find_encoder)(enum AVCodecID) = nullptr;
  const AVCodec* (*find_encoder_by_name)(const char*) = nullptr;
  AVCodecContext* (*alloc_context3)(const AVCodec*) = nullptr;
  void (*free_context3)(AVCodecContext**) = nullptr;
  int (*params_to_context)(AVCodecContext*, const AVCodecParameters*) = nullptr;
  int (*params_from_context)(AVCodecParameters*, const AVCodecContext*) = nullptr;
  int (*open2)(AVCodecContext*, const AVCodec*, AVDictionary**) = nullptr;
  int (*send_packet)(AVCodecContext*, const AVPacket*) = nullptr;
  int (*receive_frame)(AVCodecContext*, AVFrame*) = nullptr;
  int (*send_frame)(AVCodecContext*, const AVFrame*) = nullptr;
  int (*receive_packet)(AVCodecContext*, AVPacket*) = nullptr;
  AVPacket* (*packet_alloc)() = nullptr;
  void (*packet_free)(AVPacket**) = nullptr;
  void (*packet_unref)(AVPacket*) = nullptr;
  void (*packet_rescale_ts)(AVPacket*, AVRational, AVRational) = nullptr;

  // libavutil
  AVFrame* (*frame_alloc)() = nullptr;
  void (*frame_free)(AVFrame**) = nullptr;
  void (*frame_unref)(AVFrame*) = nullptr;
  int (*frame_get_buffer)(AVFrame*, int) = nullptr;
  int (*get_bytes_per_sample)(enum AVSampleFormat) = nullptr;
  void (*channel_layout_default)(AVChannelLayout*, int) = nullptr;
  int (*channel_layout_copy)(AVChannelLayout*, const AVChannelLayout*) = nullptr;
};

void* dl_or(const char* a, const char* b) {
  void* h = dlopen(a, RTLD_NOW | RTLD_GLOBAL);
  return h ? h : dlopen(b, RTLD_NOW | RTLD_GLOBAL);
}

FfApi& ff() {
  static FfApi a;
  static std::once_flag once;
  std::call_once(once, [] {
    a.lavu = dl_or("libavutil.so.57", "libavutil.so");
    a.lavc = dl_or("libavcodec.so.59", "libavcodec.so");
    a.lavf = dl_or("libavformat.so.59", "libavformat.so");
    if (!a.lavu || !a.lavc || !a.lavf) return;
#define SYM(field, lib, name)                         \
  a.field = reinterpret_cast<decltype(a.field)>(dlsym(a.lib, name)); \
  if (!a.field) return;
    SYM(open_input, lavf, "avformat_open_input")
    SYM(close_input, lavf, "avformat_close_input")
    SYM(find_stream_info, lavf, "avformat_find_stream_info")
    SYM(find_best_stream, lavf, "av_find_best_stream")
    SYM(read_frame, lavf, "av_read_frame")
    SYM(alloc_output_context2, lavf, "avformat_alloc_output_context2")
    SYM(free_context, lavf, "avformat_free_context")
    SYM(new_stream, lavf, "avformat_new_stream")
    SYM(write_header, lavf, "avformat_write_header")
    SYM(write_trailer, lavf, "av_write_trailer")
    SYM(interleaved_write_frame, lavf, "av_interleaved_write_frame")
    SYM(avio_open_, lavf, "avio_open")
    SYM(avio_closep_, lavf, "avio_closep")
    SYM(find_decoder, lavc, "avcodec_find_decoder")
    SYM(find_encoder, lavc, "avcodec_find_encoder")
    SYM(find_encoder_by_name, lavc, "avcodec_find_encoder_by_name")
    SYM(alloc_context3, lavc, "avcodec_alloc_context3")
    SYM(free_context3, lavc, "avcodec_free_context")
    SYM(params_to_context, lavc, "avcodec_parameters_to_context")
    SYM(params_from_context, lavc, "avcodec_parameters_from_context")
    SYM(open2, lavc, "avcodec_open2")
    SYM(send_packet, lavc, "avcodec_send_packet")
    SYM(receive_frame, lavc, "avcodec_receive_frame")
    SYM(send_frame, lavc, "avcodec_send_frame")
    SYM(receive_packet, lavc, "avcodec_receive_packet")
    SYM(packet_alloc, lavc, "av_packet_alloc")
    SYM(packet_free, lavc, "av_packet_free")
    SYM(packet_unref, lavc, "av_packet_unref")
    SYM(packet_rescale_ts, lavc, "av_packet_rescale_ts")
    SYM(frame_alloc, lavu, "av_frame_alloc")
    SYM(frame_free, lavu, "av_frame_free")
    SYM(frame_unref, lavu, "av_frame_unref")
    SYM(frame_get_buffer, lavu, "av_frame_get_buffer")
    SYM(get_bytes_per_sample, lavu, "av_get_bytes_per_sample")
    SYM(channel_layout_default, lavu, "av_channel_layout_default")
    SYM(channel_layout_copy, lavu, "av_channel_layout_copy")
#undef SYM
    a.ok = true;
  });
  return a;
}

// Append one decoded frame's samples as interleaved f32 (all planar/packed
// int/float formats — symphonia's S16/S24/S32/F32/F64/U8 coverage analogue).
bool append_frame(const AVFrame* fr, std::vector<float>& out) {
  const int ch = fr->ch_layout.nb_channels;
  const int n = fr->nb_samples;
  if (ch <= 0 || n <= 0) return false;
  const auto fmt = static_cast<enum AVSampleFormat>(fr->format);
  const bool planar = fmt >= AV_SAMPLE_FMT_U8P;
  size_t base = out.size();
  out.resize(base + size_t(n) * ch);

  auto at = [&](int c, int i) -> const uint8_t* {
    const int bps = ff().get_bytes_per_sample(fmt);
    return planar ? fr->data[c] + size_t(i) * bps
                  : fr->data[0] + (size_t(i) * ch + c) * bps;
  };
  for (int i = 0; i < n; i++) {
    for (int c = 0; c < ch; c++) {
      const uint8_t* p = at(c, i);
      float v;
      switch (fmt) {
        case AV_SAMPLE_FMT_FLT:
        case AV_SAMPLE_FMT_FLTP:
          std::memcpy(&v, p, 4);
          break;
        case AV_SAMPLE_FMT_DBL:
        case AV_SAMPLE_FMT_DBLP: {
          double d;
          std::memcpy(&d, p, 8);
          v = static_cast<float>(d);
          break;
        }
        case AV_SAMPLE_FMT_S16:
        case AV_SAMPLE_FMT_S16P: {
          int16_t s;
          std::memcpy(&s, p, 2);
          v = s / 32768.0f;
          break;
        }
        case AV_SAMPLE_FMT_S32:
        case AV_SAMPLE_FMT_S32P: {
          int32_t s;
          std::memcpy(&s, p, 4);
          v = s / 2147483648.0f;
          break;
        }
        case AV_SAMPLE_FMT_U8:
        case AV_SAMPLE_FMT_U8P:
          v = (int(*p) - 128) / 128.0f;
          break;
        default:
          return false;
      }
      out[base + size_t(i) * ch + c] = v;
    }
  }
  return true;
}

}  // namespace

bool ffmpeg_available() { return ff().ok; }

// Decode any ffmpeg-supported file to interleaved f32.
// Returns 0 ok, 1 open error, 2 format error, 3 unsupported, 7 unavailable.
int ffmpeg_decode_file(const char* path, std::vector<float>* interleaved,
                       int* channels_out, int* sample_rate_out) {
  FfApi& F = ff();
  if (!F.ok) return 7;

  AVFormatContext* fmt = nullptr;
  if (F.open_input(&fmt, path, nullptr, nullptr) < 0) return 1;
  int rc = 2;
  AVCodecContext* ctx = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* fr = nullptr;
  do {
    if (F.find_stream_info(fmt, nullptr) < 0) break;
    const AVCodec* dec = nullptr;
    int si = F.find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
    if (si < 0 || !dec) break;
    AVStream* st = fmt->streams[si];
    ctx = F.alloc_context3(dec);
    if (!ctx || F.params_to_context(ctx, st->codecpar) < 0) break;
    if (F.open2(ctx, dec, nullptr) < 0) break;
    pkt = F.packet_alloc();
    fr = F.frame_alloc();
    if (!pkt || !fr) break;

    interleaved->clear();
    int channels = 0, sr = 0;
    bool bad_fmt = false;
    auto drain = [&]() {
      while (F.receive_frame(ctx, fr) == 0) {
        if (!channels) {
          channels = fr->ch_layout.nb_channels;
          sr = fr->sample_rate ? fr->sample_rate : ctx->sample_rate;
        }
        if (!append_frame(fr, *interleaved)) bad_fmt = true;
        F.frame_unref(fr);
      }
    };
    while (F.read_frame(fmt, pkt) >= 0) {
      if (pkt->stream_index == si && F.send_packet(ctx, pkt) == 0) drain();
      F.packet_unref(pkt);
      if (bad_fmt) break;
    }
    F.send_packet(ctx, nullptr);  // flush
    drain();

    if (bad_fmt) {
      rc = 3;
    } else if (interleaved->empty() || channels <= 0 || sr <= 0) {
      rc = 2;
    } else {
      *channels_out = channels;
      *sample_rate_out = sr;
      rc = 0;
    }
  } while (false);
  if (fr) F.frame_free(&fr);
  if (pkt) F.packet_free(&pkt);
  if (ctx) F.free_context3(&ctx);
  F.close_input(&fmt);
  return rc;
}

// Minimal mono audio encoder — test/validation-fixture tool only (the
// analysis framework itself never encodes; this exists so hermetic lossy
// fixtures — m4a/AAC, MP3 via libmp3lame, OGG via libvorbis — can be
// produced for the decode tests and the codec-robustness battery
// families). The container is inferred from the path by
// avformat_alloc_output_context2; codec_name selects the encoder
// (nullptr/"" = AAC). All three encoders accept planar float input.
// Returns 0 on success.
int ffmpeg_encode_audio(const char* path, const char* codec_name,
                        const float* mono, int64_t n, int sample_rate) {
  FfApi& F = ff();
  if (!F.ok) return 7;

  AVFormatContext* ofmt = nullptr;
  if (F.alloc_output_context2(&ofmt, nullptr, nullptr, path) < 0 || !ofmt)
    return 2;
  int rc = 2;
  AVCodecContext* c = nullptr;
  AVFrame* fr = nullptr;
  AVPacket* pkt = nullptr;
  bool io_open = false;
  do {
    const AVCodec* enc =
        (codec_name && codec_name[0] && F.find_encoder_by_name)
            ? F.find_encoder_by_name(codec_name)
            : F.find_encoder(AV_CODEC_ID_AAC);
    if (!enc) break;
    AVStream* st = F.new_stream(ofmt, nullptr);
    c = F.alloc_context3(enc);
    if (!st || !c) break;
    c->sample_rate = sample_rate;
    c->sample_fmt = AV_SAMPLE_FMT_FLTP;
    F.channel_layout_default(&c->ch_layout, 1);
    c->bit_rate = 128000;
    c->time_base = AVRational{1, sample_rate};
    if (ofmt->oformat->flags & AVFMT_GLOBALHEADER)
      c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (F.open2(c, enc, nullptr) < 0) break;
    if (F.params_from_context(st->codecpar, c) < 0) break;
    st->time_base = c->time_base;
    if (F.avio_open_(&ofmt->pb, path, AVIO_FLAG_WRITE) < 0) break;
    io_open = true;
    if (F.write_header(ofmt, nullptr) < 0) break;

    pkt = F.packet_alloc();
    fr = F.frame_alloc();
    if (!pkt || !fr) break;
    const int fs = c->frame_size > 0 ? c->frame_size : 1024;

    auto pump = [&](const AVFrame* frame) -> bool {
      if (F.send_frame(c, frame) < 0) return false;
      while (F.receive_packet(c, pkt) == 0) {
        F.packet_rescale_ts(pkt, c->time_base, st->time_base);
        pkt->stream_index = st->index;
        if (F.interleaved_write_frame(ofmt, pkt) < 0) return false;
      }
      return true;
    };

    bool ok = true;
    for (int64_t off = 0; off < n && ok; off += fs) {
      F.frame_unref(fr);
      fr->nb_samples = fs;
      fr->format = AV_SAMPLE_FMT_FLTP;
      fr->sample_rate = sample_rate;
      F.channel_layout_copy(&fr->ch_layout, &c->ch_layout);
      if (F.frame_get_buffer(fr, 0) < 0) {
        ok = false;
        break;
      }
      float* dst = reinterpret_cast<float*>(fr->data[0]);
      const int64_t take = std::min<int64_t>(fs, n - off);
      std::memcpy(dst, mono + off, take * sizeof(float));
      if (take < fs) std::memset(dst + take, 0, (fs - take) * sizeof(float));
      fr->pts = off;
      ok = pump(fr);
    }
    if (ok) ok = pump(nullptr);  // drain encoder
    if (ok && F.write_trailer(ofmt) == 0) rc = 0;
  } while (false);
  if (fr) F.frame_free(&fr);
  if (pkt) F.packet_free(&pkt);
  if (c) F.free_context3(&c);
  if (io_open) F.avio_closep_(&ofmt->pb);
  F.free_context(ofmt);
  return rc;
}

int ffmpeg_encode_m4a(const char* path, const float* mono, int64_t n,
                      int sample_rate) {
  return ffmpeg_encode_audio(path, nullptr, mono, n, sample_rate);
}

#endif  // STRATUM_NO_FFMPEG || !__has_include(<libavcodec/avcodec.h>)
