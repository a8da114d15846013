// Native host data loader — the C++ analog of tf.data's C++ iterator/prefetch
// engine (SURVEY.md §2b row 3: the reference's input pipelines delegate
// shuffle/repeat/batch/prefetch to TensorFlow's C++ runtime; this supplies the
// same capability for the TPU-native framework).
//
// Design: N source arrays share a leading dimension. A pool of worker threads
// fills a ring of `depth` batch slots; batch b always lands in slot b % depth,
// so the consumer sees batches in deterministic order regardless of thread
// interleaving. Per-epoch Fisher-Yates shuffle (splitmix64 PRNG, seed+epoch)
// with tf.data `repeat().batch()` semantics: batches run across epoch
// boundaries, no per-epoch short batch. Row gather is memcpy — the pipeline
// is memory-bandwidth-bound, exactly what the GIL-free threads buy over the
// numpy fancy-index path.
//
// C ABI only (consumed via ctypes from tfde_tpu/native/__init__.py).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  // unbiased bounded draw (Lemire)
  uint64_t bounded(uint64_t n) {
    uint64_t x = next();
    __uint128_t m = (__uint128_t)x * (__uint128_t)n;
    uint64_t l = (uint64_t)m;
    if (l < n) {
      uint64_t t = -n % n;
      while (l < t) {
        x = next();
        m = (__uint128_t)x * (__uint128_t)n;
        l = (uint64_t)m;
      }
    }
    return (uint64_t)(m >> 64);
  }
};

struct Slot {
  std::vector<std::vector<uint8_t>> buffers;  // one per array
  int64_t batch_id = -1;     // batch currently occupying the slot
  int64_t consumed_id = -1;  // last batch fully drained from this slot
  int64_t rows = 0;          // rows actually filled (short final batch)
  bool ready = false;
  std::mutex mu;
  std::condition_variable cv;
};

struct Loader {
  // immutable config
  std::vector<const uint8_t*> data;
  std::vector<size_t> row_bytes;
  int64_t n_rows;
  int64_t batch;
  bool drop_remainder;
  bool shuffle;
  uint64_t seed;
  int64_t repeat;  // -1 = infinite
  int64_t total_batches;  // -1 = infinite

  // permutation cache (guarded by perm_mu): epoch -> shared permutation.
  // shared_ptr so a worker holding an epoch's permutation is immune to
  // concurrent eviction by workers on later epochs.
  std::mutex perm_mu;
  std::map<int64_t, std::shared_ptr<const std::vector<int64_t>>> perms;

  std::vector<Slot> slots;
  std::atomic<int64_t> next_batch{0};  // claimed by workers
  int64_t consumed = 0;                // consumer cursor
  std::atomic<bool> stop{false};
  std::atomic<int> active_next{0};  // consumers currently inside next()
  std::vector<std::thread> workers;

  std::shared_ptr<const std::vector<int64_t>> permutation_for(int64_t epoch) {
    std::lock_guard<std::mutex> g(perm_mu);
    auto it = perms.find(epoch);
    if (it != perms.end()) return it->second;
    auto p = std::make_shared<std::vector<int64_t>>(n_rows);
    for (int64_t i = 0; i < n_rows; ++i) (*p)[i] = i;
    SplitMix64 rng(seed + (uint64_t)epoch);
    for (int64_t i = n_rows - 1; i > 0; --i) {
      int64_t j = (int64_t)rng.bounded((uint64_t)i + 1);
      std::swap((*p)[i], (*p)[j]);
    }
    perms[epoch] = p;
    // bound the cache: epochs more than a prefetch-window behind are dead
    while (perms.size() > 8) perms.erase(perms.begin());
    return perms[epoch];
  }

  void fill(Slot& slot, int64_t b) {
    int64_t start = b * batch;
    int64_t limit = (repeat < 0) ? INT64_MAX : repeat * n_rows;
    int64_t end = std::min(start + batch, limit);
    int64_t rows = end - start;
    // resolve source rows once (a batch may span many epochs when
    // batch > n_rows); the permutation fetch locks only on epoch change
    std::vector<int64_t> src_rows((size_t)rows);
    if (shuffle) {
      int64_t cur_epoch = -1;
      std::shared_ptr<const std::vector<int64_t>> perm;
      for (int64_t r = 0; r < rows; ++r) {
        int64_t g = start + r;
        int64_t epoch = g / n_rows;
        if (epoch != cur_epoch) {
          perm = permutation_for(epoch);
          cur_epoch = epoch;
        }
        src_rows[(size_t)r] = (*perm)[g % n_rows];
      }
    } else {
      for (int64_t r = 0; r < rows; ++r)
        src_rows[(size_t)r] = (start + r) % n_rows;
    }
    for (size_t a = 0; a < data.size(); ++a) {
      uint8_t* dst = slot.buffers[a].data();
      size_t rb = row_bytes[a];
      for (int64_t r = 0; r < rows; ++r) {
        std::memcpy(dst + (size_t)r * rb,
                    data[a] + (size_t)src_rows[(size_t)r] * rb, rb);
      }
    }
    slot.rows = rows;
  }

  void worker() {
    for (;;) {
      int64_t b = next_batch.fetch_add(1);
      if (stop.load() || (total_batches >= 0 && b >= total_batches)) return;
      int64_t depth = (int64_t)slots.size();
      Slot& slot = slots[(size_t)(b % depth)];
      {
        // a slot is free for batch b only once batch b-depth (its previous
        // occupant) has been drained — "not ready" alone can't distinguish
        // being-filled from consumed
        std::unique_lock<std::mutex> lk(slot.mu);
        slot.cv.wait(lk, [&] {
          return stop.load() || slot.consumed_id == b - depth;
        });
        if (stop.load()) return;
        slot.batch_id = b;
      }
      fill(slot, b);
      {
        std::lock_guard<std::mutex> lk(slot.mu);
        slot.ready = true;
      }
      slot.cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* tfde_loader_create(
    int n_arrays, const void** data, const int64_t* row_bytes, int64_t n_rows,
    int64_t batch, int drop_remainder, int shuffle, uint64_t seed,
    int64_t repeat /* -1 = infinite */, int num_threads, int depth) {
  if (n_arrays <= 0 || n_rows <= 0 || batch <= 0) return nullptr;
  auto* L = new Loader();
  L->data.assign((const uint8_t**)data, (const uint8_t**)data + n_arrays);
  L->row_bytes.assign(row_bytes, row_bytes + n_arrays);
  L->n_rows = n_rows;
  L->batch = batch;
  L->drop_remainder = drop_remainder != 0;
  L->shuffle = shuffle != 0;
  L->seed = seed;
  L->repeat = repeat;
  if (repeat < 0) {
    L->total_batches = -1;
  } else {
    int64_t total_rows = repeat * n_rows;
    L->total_batches =
        L->drop_remainder ? total_rows / batch : (total_rows + batch - 1) / batch;
  }
  if (depth < 2) depth = 2;
  L->slots = std::vector<Slot>((size_t)depth);
  for (size_t i = 0; i < L->slots.size(); ++i) {
    Slot& s = L->slots[i];
    s.buffers.resize((size_t)n_arrays);
    for (int a = 0; a < n_arrays; ++a)
      s.buffers[(size_t)a].resize((size_t)batch * (size_t)row_bytes[a]);
    s.batch_id = -1;
    s.consumed_id = (int64_t)i - (int64_t)depth;  // slot i starts free for batch i
  }
  if (num_threads < 1) num_threads = 1;
  int max_threads = depth > 1 ? depth - 1 : 1;  // keep >=1 slot drainable
  if (num_threads > max_threads) num_threads = max_threads;
  for (int t = 0; t < num_threads; ++t)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Blocks for the next batch. Returns rows in the batch (0 = end of data or
// loader stopped). Buffer pointers for each array are written to out_ptrs;
// they stay valid until the matching tfde_loader_release call.
int64_t tfde_loader_next(void* handle, void** out_ptrs) {
  auto* L = (Loader*)handle;
  // Count the consumer in so a concurrent destroy waits for it to leave
  // before freeing the loader (destroy racing a blocked next() used to
  // hang the worker join — and, fixed, would otherwise free slot.mu while
  // the waiter still held it).
  L->active_next.fetch_add(1);
  struct Dec {
    std::atomic<int>* c;
    ~Dec() { c->fetch_sub(1); }
  } dec{&L->active_next};
  if (L->stop.load()) return 0;
  int64_t b = L->consumed;
  if (L->total_batches >= 0 && b >= L->total_batches) return 0;
  Slot& slot = L->slots[(size_t)b % L->slots.size()];
  std::unique_lock<std::mutex> lk(slot.mu);
  slot.cv.wait(lk, [&] {
    return L->stop.load() || (slot.ready && slot.batch_id == b);
  });
  if (L->stop.load()) return 0;
  for (size_t a = 0; a < L->data.size(); ++a)
    out_ptrs[a] = slot.buffers[a].data();
  return slot.rows;
}

// Releases the slot of the most recently next()ed batch for refill.
void tfde_loader_release(void* handle) {
  auto* L = (Loader*)handle;
  int64_t b = L->consumed;
  Slot& slot = L->slots[(size_t)b % L->slots.size()];
  {
    std::lock_guard<std::mutex> lk(slot.mu);
    slot.ready = false;
    slot.consumed_id = b;
  }
  L->consumed = b + 1;
  slot.cv.notify_all();
}

// Stop workers and wake any blocked consumer WITHOUT freeing — phase one of
// a safe cross-thread shutdown. The Python binding calls stop, waits for its
// consumers to drain out of next() (they return 0), then calls destroy; a
// consumer that captured the handle just before close() swapped it away can
// still safely enter next() between stop and destroy.
void tfde_loader_stop(void* handle) {
  auto* L = (Loader*)handle;
  L->stop.store(true);
  for (auto& s : L->slots) s.cv.notify_all();
}

// crc32c (Castagnoli) — slice-by-8 table walk. The TFRecord framing CRC is
// the decode-path bottleneck in Python (measured 13k rec/s table loop vs
// 1M rec/s for everything else, tests/test_streaming.py); at C speed the
// check is effectively free, so streaming readers keep corruption
// detection on.
static uint32_t crc_tables[8][256];
static bool crc_init_done = []() {
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
    crc_tables[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      crc_tables[t][i] =
          crc_tables[0][crc_tables[t - 1][i] & 0xFF] ^ (crc_tables[t - 1][i] >> 8);
  return true;
}();

uint32_t tfde_crc32c(const uint8_t* data, int64_t n) {
  uint32_t c = 0xFFFFFFFFu;
  const uint8_t* p = data;
  while (n >= 8) {
    uint64_t w;
    memcpy(&w, p, 8);
    w ^= c;  // little-endian hosts only (this toolchain's targets)
    c = crc_tables[7][w & 0xFF] ^ crc_tables[6][(w >> 8) & 0xFF] ^
        crc_tables[5][(w >> 16) & 0xFF] ^ crc_tables[4][(w >> 24) & 0xFF] ^
        crc_tables[3][(w >> 32) & 0xFF] ^ crc_tables[2][(w >> 40) & 0xFF] ^
        crc_tables[1][(w >> 48) & 0xFF] ^ crc_tables[0][(w >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) c = crc_tables[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

void tfde_loader_destroy(void* handle) {
  auto* L = (Loader*)handle;
  L->stop.store(true);
  for (auto& s : L->slots) s.cv.notify_all();
  for (auto& t : L->workers) t.join();
  // Wait out any consumer still inside next() (it wakes on stop and returns
  // 0); deleting while it holds slot.mu would be use-after-free.
  while (L->active_next.load() != 0) {
    for (auto& s : L->slots) s.cv.notify_all();
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  delete L;
}

}  // extern "C"
