// Native data-loading core: parallel WAV decode + batch assembly.
//
// The reference's input pipeline is a per-utterance Python loop
// (soundfile.read + numpy, lm_and_am/data_loader.py:117-156) hidden behind
// tf.data threads; at this framework's inference rates (>2500 utt/s/chip)
// a Python reader becomes the bottleneck. This library does the host-side
// heavy lifting in C++:
//
//   - RIFF/WAVE PCM parsing (16/8/32-bit, mono-mixdown) straight into a
//     caller-provided float32 batch buffer, scaled to [-1, 1],
//   - a persistent pthread pool so a whole batch of files decodes in
//     parallel with zero Python involvement per file,
//   - header-only length probing for bucketing.
//
// Exposed as a C ABI for ctypes (no pybind11 dependency); see
// asr_dfcnn_transformer_tpu/data/native_loader.py. Build: make -C native
// (produces libasrwav.so).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint64_t data_offset = 0;
  uint64_t data_bytes = 0;
};

// Minimal RIFF parser: finds "fmt " and "data" chunks.
bool parse_header(FILE* f, WavInfo* info) {
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return false;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0)
    return false;
  unsigned char chunk[8];
  while (fread(chunk, 1, 8, f) == 8) {
    uint32_t size = chunk[4] | (chunk[5] << 8) | (chunk[6] << 16) |
                    ((uint32_t)chunk[7] << 24);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      unsigned char fmt[16];
      size_t want = size < 16 ? size : 16;
      if (fread(fmt, 1, want, f) != want) return false;
      info->channels = fmt[2] | (fmt[3] << 8);
      info->sample_rate = fmt[4] | (fmt[5] << 8) | (fmt[6] << 16) |
                          ((uint32_t)fmt[7] << 24);
      info->bits = fmt[14] | (fmt[15] << 8);
      if (size > want && fseek(f, (long)(size - want), SEEK_CUR) != 0)
        return false;
    } else if (memcmp(chunk, "data", 4) == 0) {
      info->data_offset = (uint64_t)ftell(f);
      info->data_bytes = size;
      // Only PCM widths the decoder handles; anything else (including
      // bits<8, which would make bytes_per==0 and SIGFPE the division
      // below) is a parse failure, not a crash.
      return (info->channels > 0 && info->channels <= 64) &&
             (info->bits == 8 || info->bits == 16 || info->bits == 32);
    } else {
      // chunks are word-aligned
      if (fseek(f, (long)(size + (size & 1)), SEEK_CUR) != 0) return false;
    }
  }
  return false;
}

// Decode one file into out[0..max_samples), return #samples written or -1.
int64_t decode_file(const char* path, float* out, int64_t max_samples) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -1;
  }
  const int bytes_per = info.bits / 8;
  const int64_t frames =
      (int64_t)(info.data_bytes / (bytes_per * info.channels));
  const int64_t n = frames < max_samples ? frames : max_samples;
  std::vector<unsigned char> raw((size_t)n * bytes_per * info.channels);
  if (fseek(f, (long)info.data_offset, SEEK_SET) != 0 ||
      fread(raw.data(), 1, raw.size(), f) != raw.size()) {
    fclose(f);
    return -1;
  }
  fclose(f);
  const int ch = info.channels;
  if (info.bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(raw.data());
    for (int64_t i = 0; i < n; ++i) {
      float acc = 0.f;
      for (int c = 0; c < ch; ++c) acc += (float)s[i * ch + c];
      out[i] = acc / (ch * 32768.0f);
    }
  } else if (info.bits == 8) {
    const unsigned char* s = raw.data();
    for (int64_t i = 0; i < n; ++i) {
      float acc = 0.f;
      for (int c = 0; c < ch; ++c) acc += (float)s[i * ch + c] - 128.0f;
      out[i] = acc / (ch * 128.0f);
    }
  } else if (info.bits == 32) {
    const int32_t* s = reinterpret_cast<const int32_t*>(raw.data());
    for (int64_t i = 0; i < n; ++i) {
      double acc = 0.0;
      for (int c = 0; c < ch; ++c) acc += (double)s[i * ch + c];
      out[i] = (float)(acc / (ch * 2147483648.0));
    }
  } else {
    return -1;
  }
  return n;
}

// ---- persistent thread pool --------------------------------------------

class Pool {
 public:
  explicit Pool(int n) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { run(); });
  }
  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      done_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> f) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      q_.push(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  void run() {
    for (;;) {
      std::function<void()> f;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return done_ || !q_.empty(); });
        if (done_ && q_.empty()) return;
        f = std::move(q_.front());
        q_.pop();
      }
      f();
    }
  }
  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<std::function<void()>> q_;
  std::vector<std::thread> workers_;
  bool done_ = false;
};

Pool* pool() {
  static Pool p(std::max(2u, std::thread::hardware_concurrency()));
  return &p;
}

}  // namespace

extern "C" {

// Probe: returns sample count (frames) or -1; fills sample_rate.
int64_t asrwav_probe(const char* path, int32_t* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = parse_header(f, &info);
  fclose(f);
  if (!ok) return -1;
  if (sample_rate) *sample_rate = (int32_t)info.sample_rate;
  return (int64_t)(info.data_bytes / ((info.bits / 8) * info.channels));
}

// Decode a batch of files in parallel.
//   paths: array of B C-strings; out: [B, max_samples] float32 buffer
//   (zero-filled by caller or not — rows are fully written up to the
//   returned length, the tail is zeroed here);
//   lengths: [B] int64 out (samples written, -1 on per-file failure).
// Returns number of successfully decoded files.
int32_t asrwav_decode_batch(const char** paths, int32_t batch,
                            float* out, int64_t max_samples,
                            int64_t* lengths) {
  std::atomic<int32_t> ok{0};
  // remaining is guarded by done_mu (NOT atomic): the waiter owns these
  // stack locals and destroys them on return, so the last worker's
  // decrement-and-notify must be one critical section — an atomic
  // decrement before the lock would let a spurious wakeup observe 0,
  // return, and destroy the mutex the worker is about to lock.
  int32_t remaining = batch;
  std::mutex done_mu;
  std::condition_variable done_cv;
  for (int32_t i = 0; i < batch; ++i) {
    pool()->submit([&, i] {
      float* row = out + (int64_t)i * max_samples;
      int64_t n = decode_file(paths[i], row, max_samples);
      if (n >= 0) {
        memset(row + n, 0, (size_t)(max_samples - n) * sizeof(float));
        ok.fetch_add(1);
      } else {
        memset(row, 0, (size_t)max_samples * sizeof(float));
      }
      lengths[i] = n;
      {
        std::unique_lock<std::mutex> lk(done_mu);
        if (--remaining == 0) done_cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return remaining == 0; });
  return ok.load();
}

}  // extern "C"
