// Native token-corpus reader: the trainer's data plane.
//
// Why native: the input pipeline must assemble [batch, seq] int32 windows
// from multi-GiB token shards every step without stealing Python time from
// the dispatch thread.  This reader mmaps the shards (the OS page cache is
// the shuffle buffer; no heap copy of the corpus), samples deterministic
// random crops with a splitmix64 counter scheme (seed, step, row) — so a
// resumed run reads exactly the batches the interrupted one would have —
// and double-buffers: a worker thread assembles batch N+1 while the
// caller consumes batch N (ctypes releases the GIL around the call, so
// the copy genuinely overlaps the training step's dispatch).
//
// Exposed as plain extern "C" for ctypes (no pybind11 in this image);
// the Python binding lives in native/tokenreader.py.  File format:
// raw little-endian uint16 or uint32 tokens, any number of "*.bin"
// shards; shard boundaries are treated as a contiguous global stream
// (crops never span a boundary — see pick_offset).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Shard {
  const uint8_t* data = nullptr;  // mmapped
  size_t bytes = 0;
  long long tokens = 0;
  long long first = 0;  // global index of this shard's token 0
  int fd = -1;
};

// splitmix64: the standard 64-bit mixing function — a counter keyed by
// (seed, step, row) gives an independent, reproducible stream per row.
uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

struct Reader {
  std::vector<Shard> shards;
  int token_bytes = 2;
  long long total_tokens = 0;
  long long min_shard_tokens = 0;  // crop-safety bound for fill requests

  // double buffer: the worker fills `next` for key (step+1) while the
  // caller copies `ready` out
  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;
  bool closing = false;
  bool job_pending = false;  // a request is queued, worker not started
  bool job_busy = false;     // worker is assembling the queued request
  // prefetched batch
  std::vector<int32_t> prefetched;
  long long prefetched_step = -1;
  long long pf_batch = 0, pf_seq = 0;
  uint64_t pf_seed = 0;
  // job request
  long long job_step = 0, job_batch = 0, job_seq = 0;
  uint64_t job_seed = 0;

  ~Reader() {
    {
      std::unique_lock<std::mutex> lock(mu);
      closing = true;
      cv.notify_all();
    }
    if (worker.joinable()) worker.join();
    for (auto& s : shards) {
      if (s.data) munmap(const_cast<uint8_t*>(s.data), s.bytes);
      if (s.fd >= 0) close(s.fd);
    }
  }

  const Shard& shard_for(long long global_token) const {
    // binary search over first-token prefix sums
    size_t lo = 0, hi = shards.size() - 1;
    while (lo < hi) {
      size_t mid = (lo + hi + 1) / 2;
      if (shards[mid].first <= global_token) lo = mid;
      else hi = mid - 1;
    }
    return shards[lo];
  }

  // Deterministic crop start for (seed, step, row): uniform over the
  // crops of the shard a uniform global token lands in, never spanning a
  // shard boundary (every shard must hold >= seq + 1 tokens — validated
  // at open).  +1: a training window of `seq` inputs needs seq tokens;
  // the LM shift happens on the logits, so windows are seq long here.
  long long pick_offset(uint64_t seed, long long step, long long row,
                        long long seq) const {
    uint64_t h = splitmix64(seed ^ splitmix64(
        static_cast<uint64_t>(step) * 0x100000001b3ULL ^
        static_cast<uint64_t>(row)));
    const Shard& s = shard_for(static_cast<long long>(
        h % static_cast<uint64_t>(total_tokens)));
    uint64_t crops = static_cast<uint64_t>(s.tokens - seq + 1);
    return s.first + static_cast<long long>(splitmix64(h) % crops);
  }

  void copy_window(long long global_start, long long seq,
                   int32_t* out) const {
    const Shard& s = shard_for(global_start);
    long long local = global_start - s.first;
    if (token_bytes == 2) {
      const uint16_t* src =
          reinterpret_cast<const uint16_t*>(s.data) + local;
      for (long long i = 0; i < seq; ++i) out[i] = src[i];
    } else {
      const int32_t* src =
          reinterpret_cast<const int32_t*>(s.data) + local;
      std::memcpy(out, src, sizeof(int32_t) * seq);
    }
  }

  void fill(int32_t* out, long long batch, long long seq, uint64_t seed,
            long long step) const {
    for (long long row = 0; row < batch; ++row) {
      copy_window(pick_offset(seed, step, row, seq), seq,
                  out + row * seq);
    }
  }

  void worker_loop() {
    std::unique_lock<std::mutex> lock(mu);
    while (true) {
      cv.wait(lock, [&] { return closing || job_pending; });
      if (closing) return;
      long long step = job_step, batch = job_batch, seq = job_seq;
      uint64_t seed = job_seed;
      job_pending = false;
      job_busy = true;  // callers wanting (step,batch,seq,seed) wait on us
      std::vector<int32_t> buf(
          static_cast<size_t>(batch) * static_cast<size_t>(seq));
      lock.unlock();
      fill(buf.data(), batch, seq, seed, step);  // shards are immutable
      lock.lock();
      prefetched = std::move(buf);
      prefetched_step = step;
      pf_batch = batch;
      pf_seq = seq;
      pf_seed = seed;
      job_busy = false;
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// paths: n null-terminated shard paths.  token_bytes: 2 (uint16) or 4
// (int32).  min_tokens_per_shard: validation bound (seq) — shards
// smaller than this are an error (-3).  Returns a handle or null.
void* tr_open(const char** paths, long long n, int token_bytes,
              long long min_tokens_per_shard, long long* total_out,
              int* err_out) {
  auto fail = [&](int code) -> void* {
    if (err_out) *err_out = code;
    return nullptr;
  };
  if (n <= 0 || (token_bytes != 2 && token_bytes != 4)) return fail(-1);
  auto reader = new Reader();
  reader->token_bytes = token_bytes;
  long long first = 0;
  for (long long i = 0; i < n; ++i) {
    Shard s;
    s.fd = open(paths[i], O_RDONLY);
    if (s.fd < 0) {
      delete reader;
      return fail(-2);
    }
    struct stat st;
    fstat(s.fd, &st);
    s.bytes = static_cast<size_t>(st.st_size);
    s.tokens = static_cast<long long>(s.bytes) / token_bytes;
    if (s.tokens < min_tokens_per_shard) {
      close(s.fd);
      delete reader;
      return fail(-3);
    }
    s.data = static_cast<const uint8_t*>(
        mmap(nullptr, s.bytes, PROT_READ, MAP_PRIVATE, s.fd, 0));
    if (s.data == MAP_FAILED) {
      close(s.fd);
      delete reader;
      return fail(-4);
    }
    madvise(const_cast<uint8_t*>(s.data), s.bytes, MADV_RANDOM);
    s.first = first;
    first += s.tokens;
    reader->shards.push_back(s);
  }
  reader->total_tokens = first;
  reader->min_shard_tokens = reader->shards[0].tokens;
  for (const auto& s : reader->shards) {
    reader->min_shard_tokens = std::min(reader->min_shard_tokens, s.tokens);
  }
  reader->worker = std::thread(&Reader::worker_loop, reader);
  if (total_out) *total_out = first;
  if (err_out) *err_out = 0;
  return reader;
}

long long tr_total_tokens(void* handle) {
  return static_cast<Reader*>(handle)->total_tokens;
}

// Fill [batch, seq] int32 tokens for (seed, step).  Serves from the
// prefetch buffer when the worker already assembled this exact request,
// else assembles synchronously; either way kicks off a prefetch of
// step+1 before returning.  Returns 0, or -1 when `seq` exceeds the
// smallest shard (pick_offset's crops-per-shard count would underflow
// into an out-of-bounds read).
int tr_fill_batch(void* handle, int32_t* out, long long batch,
                  long long seq, uint64_t seed, long long step) {
  auto* r = static_cast<Reader*>(handle);
  if (seq < 1 || batch < 1 || seq > r->min_shard_tokens) return -1;
  bool served = false;
  {
    std::unique_lock<std::mutex> lock(r->mu);
    // if this exact request is queued or mid-assembly, wait for the
    // worker to publish it instead of duplicating the copy here
    r->cv.wait(lock, [&] {
      bool ours = r->job_step == step && r->job_batch == batch &&
                  r->job_seq == seq && r->job_seed == seed;
      return !(ours && (r->job_pending || r->job_busy));
    });
    if (r->prefetched_step == step && r->pf_batch == batch &&
        r->pf_seq == seq && r->pf_seed == seed) {
      std::memcpy(out, r->prefetched.data(),
                  sizeof(int32_t) * static_cast<size_t>(batch) *
                      static_cast<size_t>(seq));
      served = true;
    }
  }
  if (!served) r->fill(out, batch, seq, seed, step);
  {
    std::unique_lock<std::mutex> lock(r->mu);
    r->job_step = step + 1;
    r->job_batch = batch;
    r->job_seq = seq;
    r->job_seed = seed;
    r->job_pending = true;
    r->cv.notify_all();
  }
  return 0;
}

void tr_close(void* handle) { delete static_cast<Reader*>(handle); }

}  // extern "C"
