// Native async audio-batch loader.
//
// The reference's data pipeline runs audio decode in DataLoader worker
// PROCESSES (reference: src/data.py:127, collate in src/collect_batch.py);
// here the equivalent is a C++ thread pool that decodes audio files and
// assembles padded (B, S) float32 batches off the Python thread (no GIL),
// overlapping host IO with device compute. Exposed through a small C API
// consumed via ctypes (see data/native_loader.py).
//
// Supported input:
//   * PCM16/24/32 + float32 RIFF/WAVE, mono or multichannel (averaged);
//   * FLAC (RFC 9639 subset: constant / verbatim / fixed / LPC subframes,
//     RICE + RICE2 residuals, stereo decorrelation, wasted bits) — the
//     LibriSpeech corpus format (reference decodes it via libsndfile inside
//     librosa, src/audio.py:289).
// Batches complete in submit order.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fstream>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// --------------------------------------------------------------- FLAC

// MSB-first bit reader over an in-memory buffer.
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte = 0;
  int bit = 0;  // bits consumed of data[byte], 0..7
  bool fail = false;

  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}

  inline uint64_t bits(int n) {  // n <= 57
    uint64_t v = 0;
    while (n > 0) {
      if (byte >= size) { fail = true; return 0; }
      int avail = 8 - bit;
      int take = n < avail ? n : avail;
      int shift = avail - take;
      v = (v << take) | ((data[byte] >> shift) & ((1u << take) - 1));
      bit += take;
      n -= take;
      if (bit == 8) { bit = 0; ++byte; }
    }
    return v;
  }

  inline int64_t sbits(int n) {  // signed, two's complement
    if (n == 0) return 0;
    uint64_t v = bits(n);
    uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? (int64_t)(v - (sign << 1)) : (int64_t)v;
  }

  inline uint32_t unary() {  // count 0s until a 1
    uint32_t q = 0;
    for (;;) {
      if (byte >= size) { fail = true; return 0; }
      uint8_t cur = data[byte] & (0xFFu >> bit);
      if (cur == 0) {
        q += 8 - bit;
        bit = 0;
        ++byte;
        continue;
      }
      int lead = __builtin_clz((uint32_t)cur) - 24;  // zeros from bit `bit`
      q += lead - bit;
      bit = lead + 1;
      if (bit == 8) { bit = 0; ++byte; }
      return q;
    }
  }

  inline void align() {
    if (bit != 0) { bit = 0; ++byte; }
  }
};

// UTF-8-style coded number (frame/sample index), up to 36 bits.
inline uint64_t read_utf8_num(BitReader* br) {
  uint64_t b0 = br->bits(8);
  if ((b0 & 0x80) == 0) return b0;
  int n = 0;
  uint8_t m = 0x40;
  while (b0 & m) { ++n; m >>= 1; }
  uint64_t v = b0 & (m - 1);
  for (int i = 0; i < n; ++i) v = (v << 6) | (br->bits(8) & 0x3F);
  return v;
}

// Decode one residual array (after warmup) into res[pred_order..blocksize).
inline bool read_residual(BitReader* br, int blocksize, int pred_order,
                          int64_t* res) {
  int method = (int)br->bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 15 : 31;
  int po = (int)br->bits(4);
  int parts = 1 << po;
  if (blocksize % parts != 0) return false;
  int psize = blocksize >> po;
  if (psize <= pred_order && parts == 1) return false;
  int idx = pred_order;
  for (int p = 0; p < parts; ++p) {
    int count = psize - (p == 0 ? pred_order : 0);
    if (count < 0) return false;
    uint32_t param = (uint32_t)br->bits(plen);
    if (param == escape) {
      int raw = (int)br->bits(5);
      for (int i = 0; i < count; ++i)
        res[idx++] = raw == 0 ? 0 : br->sbits(raw);
    } else {
      for (int i = 0; i < count; ++i) {
        uint64_t q = br->unary();
        uint64_t u = (q << param) | br->bits((int)param);
        res[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (br->fail) return false;
  }
  return idx == blocksize;
}

// Decode one subframe into smp[0..blocksize).
inline bool read_subframe(BitReader* br, int blocksize, int bps,
                          int64_t* smp) {
  if (br->bits(1) != 0) return false;  // padding bit
  int type = (int)br->bits(6);
  int wasted = 0;
  if (br->bits(1)) wasted = (int)br->unary() + 1;
  bps -= wasted;
  if (bps <= 0 || bps > 33) return false;

  if (type == 0) {  // CONSTANT
    int64_t v = br->sbits(bps);
    for (int i = 0; i < blocksize; ++i) smp[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) smp[i] = br->sbits(bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
    int order = type & 0x07;
    for (int i = 0; i < order; ++i) smp[i] = br->sbits(bps);
    if (!read_residual(br, blocksize, order, smp)) return false;
    switch (order) {
      case 0: break;
      case 1:
        for (int i = 1; i < blocksize; ++i) smp[i] += smp[i - 1];
        break;
      case 2:
        for (int i = 2; i < blocksize; ++i)
          smp[i] += 2 * smp[i - 1] - smp[i - 2];
        break;
      case 3:
        for (int i = 3; i < blocksize; ++i)
          smp[i] += 3 * smp[i - 1] - 3 * smp[i - 2] + smp[i - 3];
        break;
      case 4:
        for (int i = 4; i < blocksize; ++i)
          smp[i] += 4 * smp[i - 1] - 6 * smp[i - 2] + 4 * smp[i - 3] -
                    smp[i - 4];
        break;
    }
  } else if (type & 0x20) {  // LPC
    int order = (type & 0x1F) + 1;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) smp[i] = br->sbits(bps);
    int precision = (int)br->bits(4) + 1;
    if (precision == 16 /* 15+1: code 15 is invalid */) return false;
    int shift = (int)br->sbits(5);
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; ++i) coef[i] = br->sbits(precision);
    if (!read_residual(br, blocksize, order, smp)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coef[j] * smp[i - 1 - j];
      smp[i] += acc >> shift;
    }
  } else {
    return false;  // reserved type
  }
  if (br->fail) return false;
  if (wasted > 0)
    for (int i = 0; i < blocksize; ++i) smp[i] <<= wasted;
  return true;
}

// Full-stream FLAC decode -> float32 mono in [-1, 1).
bool read_flac(const std::string& path, std::vector<float>* out,
               int32_t* rate) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::vector<uint8_t> data((std::istreambuf_iterator<char>(f)),
                            std::istreambuf_iterator<char>());
  if (data.size() < 42 || std::memcmp(data.data(), "fLaC", 4) != 0)
    return false;

  // metadata blocks; STREAMINFO is mandatory first
  size_t pos = 4;
  uint32_t stream_rate = 0;
  int stream_ch = 0, stream_bps = 0;
  uint64_t total_samples = 0;
  bool last = false;
  bool have_si = false;
  while (!last && pos + 4 <= data.size()) {
    uint8_t hdr = data[pos];
    last = hdr & 0x80;
    int btype = hdr & 0x7F;
    uint32_t len = (data[pos + 1] << 16) | (data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (btype == 0 && len >= 34 && pos + 34 <= data.size()) {
      const uint8_t* si = data.data() + pos;
      stream_rate = (si[10] << 12) | (si[11] << 4) | (si[12] >> 4);
      stream_ch = ((si[12] >> 1) & 0x07) + 1;
      stream_bps = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1;
      total_samples = ((uint64_t)(si[13] & 0x0F) << 32) | (si[14] << 24) |
                      (si[15] << 16) | (si[16] << 8) | si[17];
      have_si = true;
    }
    pos += len;
  }
  if (!have_si || stream_rate == 0 || stream_ch < 1 || stream_ch > 8)
    return false;
  *rate = (int32_t)stream_rate;
  out->clear();
  if (total_samples) out->reserve(total_samples);

  std::vector<std::vector<int64_t>> ch(stream_ch);
  BitReader br(data.data(), data.size());
  br.byte = pos;

  while (br.byte + 2 < data.size()) {
    // frame header
    uint32_t sync = (uint32_t)br.bits(15);
    if (br.fail) break;
    if (sync != 0x7FFC) return !out->empty();  // corrupt tail: keep decoded
    br.bits(1);  // blocking strategy
    int bs_code = (int)br.bits(4);
    int sr_code = (int)br.bits(4);
    int ch_asgn = (int)br.bits(4);
    int sz_code = (int)br.bits(3);
    br.bits(1);  // reserved
    read_utf8_num(&br);
    int blocksize;
    switch (bs_code) {
      case 0: return false;
      case 1: blocksize = 192; break;
      case 6: blocksize = (int)br.bits(8) + 1; break;
      case 7: blocksize = (int)br.bits(16) + 1; break;
      default:
        blocksize = bs_code <= 5 ? 576 << (bs_code - 2)
                                 : 256 << (bs_code - 8);
    }
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    else if (sr_code == 15) return false;
    br.bits(8);  // header CRC-8 (unverified; the md5 in STREAMINFO is the
                 // integrity story for batch loading)
    static const int kSize[8] = {0, 8, 12, 0, 16, 20, 24, 32};
    int bps = sz_code == 0 ? stream_bps : kSize[sz_code];
    if (bps == 0) return false;

    int n_ch = ch_asgn < 8 ? ch_asgn + 1 : 2;
    if (ch_asgn >= 11 || n_ch != stream_ch) return false;
    for (int c = 0; c < n_ch; ++c) {
      int sub_bps = bps;
      if ((ch_asgn == 8 && c == 1) || (ch_asgn == 9 && c == 0) ||
          (ch_asgn == 10 && c == 1))
        ++sub_bps;  // side channel carries one extra bit
      ch[c].resize(blocksize);
      if (!read_subframe(&br, blocksize, sub_bps, ch[c].data()))
        return false;
    }
    br.align();
    br.bits(16);  // frame CRC-16
    if (br.fail) return false;

    // stereo decorrelation
    if (ch_asgn == 8) {  // left/side
      for (int i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (ch_asgn == 9) {  // right/side: ch0=side ch1=right
      for (int i = 0; i < blocksize; ++i) ch[0][i] += ch[1][i];
    } else if (ch_asgn == 10) {  // mid/side
      for (int i = 0; i < blocksize; ++i) {
        int64_t mid = (ch[0][i] << 1) | (ch[1][i] & 1);
        int64_t side = ch[1][i];
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }

    double scale = 1.0 / (double)(1ll << (bps - 1));
    for (int i = 0; i < blocksize; ++i) {
      double acc = 0.0;
      for (int c = 0; c < stream_ch; ++c) acc += (double)ch[c][i];
      out->push_back((float)(acc / stream_ch * scale));
    }
    if (total_samples && out->size() >= total_samples) break;
  }
  if (total_samples && out->size() > total_samples)
    out->resize(total_samples);
  return !out->empty();
}

// Fast header-only sample count (for duration sorting / bucket planning).
int64_t flac_total_samples(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  uint8_t hdr[42];
  f.read(reinterpret_cast<char*>(hdr), 42);
  if (f.gcount() < 42 || std::memcmp(hdr, "fLaC", 4) != 0) return -1;
  const uint8_t* si = hdr + 8;  // first block body (STREAMINFO mandatory)
  if ((hdr[4] & 0x7F) != 0) return -1;
  return ((int64_t)(si[13] & 0x0F) << 32) | ((int64_t)si[14] << 24) |
         (si[15] << 16) | (si[16] << 8) | si[17];
}

bool read_wav(const std::string& path, std::vector<float>* out,
              int32_t* rate) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::vector<char> data((std::istreambuf_iterator<char>(f)),
                         std::istreambuf_iterator<char>());
  if (data.size() < 44 || std::memcmp(data.data(), "RIFF", 4) != 0 ||
      std::memcmp(data.data() + 8, "WAVE", 4) != 0)
    return false;
  size_t pos = 12;
  uint16_t fmt = 0, channels = 0, bits = 0;
  const char* raw = nullptr;
  size_t raw_size = 0;
  while (pos + 8 <= data.size()) {
    uint32_t size;
    std::memcpy(&size, data.data() + pos + 4, 4);
    const char* id = data.data() + pos;
    const char* body = data.data() + pos + 8;
    if (std::memcmp(id, "fmt ", 4) == 0 && size >= 16) {
      std::memcpy(&fmt, body, 2);
      std::memcpy(&channels, body + 2, 2);
      std::memcpy(rate, body + 4, 4);
      std::memcpy(&bits, body + 14, 2);
    } else if (std::memcmp(id, "data", 4) == 0) {
      raw = body;
      raw_size = std::min<size_t>(size, data.size() - (pos + 8));
    }
    pos += 8 + size + (size & 1);
  }
  if (raw == nullptr || channels == 0) return false;

  size_t bytes_per = bits / 8;
  size_t n_frames = raw_size / (bytes_per * channels);
  out->resize(n_frames);
  for (size_t i = 0; i < n_frames; ++i) {
    double acc = 0.0;
    for (size_t c = 0; c < channels; ++c) {
      const char* p = raw + (i * channels + c) * bytes_per;
      double v = 0.0;
      if (fmt == 3 && bits == 32) {  // float32
        float fv;
        std::memcpy(&fv, p, 4);
        v = fv;
      } else if (bits == 16) {
        int16_t s;
        std::memcpy(&s, p, 2);
        v = s / 32768.0;
      } else if (bits == 32) {
        int32_t s;
        std::memcpy(&s, p, 4);
        v = s / 2147483648.0;
      } else if (bits == 24) {
        int32_t s = (uint8_t)p[0] | ((uint8_t)p[1] << 8) |
                    ((int8_t)p[2] << 16);
        v = s / 8388608.0;
      } else if (bits == 8) {
        v = ((uint8_t)*p - 128) / 128.0;
      }
      acc += v;
    }
    (*out)[i] = static_cast<float>(acc / channels);
  }
  return true;
}

bool read_audio(const std::string& path, std::vector<float>* out,
                int32_t* rate) {
  size_t dot = path.rfind('.');
  std::string ext = dot == std::string::npos ? "" : path.substr(dot);
  if (ext == ".flac") return read_flac(path, out, rate);
  return read_wav(path, out, rate);
}

struct Job {
  int64_t id;
  std::vector<std::string> paths;
  int64_t cap_samples;
  // results
  std::vector<float> wav;      // B * cap
  std::vector<int32_t> lens;   // B
  std::atomic<int> remaining;
  bool failed = false;
};

struct Loader {
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work;
  std::condition_variable cv_done;
  std::deque<std::pair<Job*, size_t>> work;  // (job, item index)
  std::deque<std::unique_ptr<Job>> pending;  // submit order
  bool stop = false;

  explicit Loader(int n_workers) {
    for (int i = 0; i < n_workers; ++i)
      workers.emplace_back([this] { this->run(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> l(mu);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
  }

  void run() {
    for (;;) {
      std::pair<Job*, size_t> item;
      {
        std::unique_lock<std::mutex> l(mu);
        cv_work.wait(l, [this] { return stop || !work.empty(); });
        if (stop) return;
        item = work.front();
        work.pop_front();
      }
      Job* job = item.first;
      size_t idx = item.second;
      std::vector<float> wav;
      int32_t rate = 0;
      bool ok = read_audio(job->paths[idx], &wav, &rate);
      int64_t cap = job->cap_samples;
      float* dst = job->wav.data() + idx * cap;
      if (ok) {
        int64_t n = std::min<int64_t>(wav.size(), cap);
        std::memcpy(dst, wav.data(), n * sizeof(float));
        job->lens[idx] = static_cast<int32_t>(n);
      } else {
        job->lens[idx] = 0;
        job->failed = true;
      }
      if (job->remaining.fetch_sub(1) == 1) cv_done.notify_all();
    }
  }

  void submit(int64_t id, const char** paths, int64_t n, int64_t cap) {
    auto job = std::make_unique<Job>();
    job->id = id;
    job->cap_samples = cap;
    job->paths.reserve(n);
    for (int64_t i = 0; i < n; ++i) job->paths.emplace_back(paths[i]);
    job->wav.assign(static_cast<size_t>(n) * cap, 0.0f);
    job->lens.assign(n, 0);
    job->remaining.store(static_cast<int>(n));
    Job* raw_job = job.get();
    {
      std::lock_guard<std::mutex> l(mu);
      pending.push_back(std::move(job));
      for (int64_t i = 0; i < n; ++i)
        work.emplace_back(raw_job, static_cast<size_t>(i));
    }
    cv_work.notify_all();
  }

  // wait for the OLDEST submitted job; copy out; returns id, or -1 on error
  int64_t wait(float* out_wav, int32_t* out_lens) {
    std::unique_ptr<Job> job;
    {
      std::unique_lock<std::mutex> l(mu);
      if (pending.empty()) return -1;
      Job* front = pending.front().get();
      cv_done.wait(l, [front] { return front->remaining.load() == 0; });
      job = std::move(pending.front());
      pending.pop_front();
    }
    std::memcpy(out_wav, job->wav.data(), job->wav.size() * sizeof(float));
    std::memcpy(out_lens, job->lens.data(),
                job->lens.size() * sizeof(int32_t));
    return job->failed ? -2 : job->id;
  }
};

}  // namespace

extern "C" {

void* dl_create(int n_workers) { return new Loader(n_workers); }

void dl_destroy(void* h) { delete static_cast<Loader*>(h); }

void dl_submit(void* h, int64_t id, const char** paths, int64_t n,
               int64_t cap_samples) {
  static_cast<Loader*>(h)->submit(id, paths, n, cap_samples);
}

int64_t dl_wait(void* h, float* out_wav, int32_t* out_lens) {
  return static_cast<Loader*>(h)->wait(out_wav, out_lens);
}

// one-shot decode helper (single file; wav or flac), for tests / callers
int64_t dl_read_wav(const char* path, float* out, int64_t cap,
                    int32_t* rate) {
  std::vector<float> wav;
  int32_t r = 0;
  if (!read_audio(path, &wav, &r)) return -1;
  int64_t n = std::min<int64_t>(wav.size(), cap);
  std::memcpy(out, wav.data(), n * sizeof(float));
  *rate = r;
  return n;
}

// FLAC STREAMINFO sample count without decoding (duration sort / planning)
int64_t dl_flac_total_samples(const char* path) {
  return flac_total_samples(path);
}

}  // extern "C"
