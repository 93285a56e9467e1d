// Host-side data pipeline of accelerate_tpu_torch: the JAX package's
// native/src/pipeline.cc, which holds no JAX, carried over unchanged below
// this comment.
//
// Components (a C ABI, loaded through ctypes by ../__init__.py):
//   1. atpu_collate / atpu_gather_rows: batch assembly by memcpy, over a
//      transient thread team for large batches.
//   2. atpu_dataset_* / atpu_loader_*: a memory-mapped dataset of fixed-size
//      records (token shards for LM pretraining) and a prefetching loader
//      whose worker threads assemble whole batches (epoch shuffle from a
//      seeded mt19937_64, drop-last or wraparound) into a reorder window, so
//      batches come out in a deterministic order.
//
// Built at first use with the host compiler by ops/_build.py (build_host).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------- collation --

// Copy n_samples buffers (each sample_bytes long, addresses in srcs[]) into
// dst, which must hold n_samples*sample_bytes. Parallelized over a transient
// thread team; for small batches the spawn cost dominates, so run inline below
// a threshold.
void atpu_collate(const void** srcs, int64_t n_samples, int64_t sample_bytes,
                  void* dst, int32_t num_threads) {
  const int64_t total = n_samples * sample_bytes;
  if (num_threads <= 1 || total < (1 << 20)) {
    for (int64_t i = 0; i < n_samples; ++i) {
      memcpy(static_cast<char*>(dst) + i * sample_bytes, srcs[i], sample_bytes);
    }
    return;
  }
  std::vector<std::thread> team;
  team.reserve(num_threads);
  std::atomic<int64_t> next(0);
  for (int32_t t = 0; t < num_threads; ++t) {
    team.emplace_back([&]() {
      int64_t i;
      while ((i = next.fetch_add(1, std::memory_order_relaxed)) < n_samples) {
        memcpy(static_cast<char*>(dst) + i * sample_bytes, srcs[i],
               sample_bytes);
      }
    });
  }
  for (auto& th : team) th.join();
}

// Strided gather: pick rows indices[0..n) from a (num_rows, row_bytes) source
// matrix into dst — the inner loop of shuffled in-memory batch assembly.
void atpu_gather_rows(const void* src, const int64_t* indices, int64_t n,
                      int64_t row_bytes, void* dst) {
  for (int64_t i = 0; i < n; ++i) {
    memcpy(static_cast<char*>(dst) + i * row_bytes,
           static_cast<const char*>(src) + indices[i] * row_bytes, row_bytes);
  }
}

// ------------------------------------------------------------------ dataset --

struct AtpuDataset {
  int fd = -1;
  const char* data = nullptr;  // mmap base
  int64_t file_bytes = 0;
  int64_t record_bytes = 0;
  int64_t num_records = 0;
};

AtpuDataset* atpu_dataset_open(const char* path, int64_t record_bytes) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  madvise(base, st.st_size, MADV_WILLNEED);
  auto* ds = new AtpuDataset();
  ds->fd = fd;
  ds->data = static_cast<const char*>(base);
  ds->file_bytes = st.st_size;
  ds->record_bytes = record_bytes;
  ds->num_records = st.st_size / record_bytes;
  return ds;
}

int64_t atpu_dataset_len(const AtpuDataset* ds) { return ds->num_records; }

void atpu_dataset_close(AtpuDataset* ds) {
  if (!ds) return;
  if (ds->data) munmap(const_cast<char*>(ds->data), ds->file_bytes);
  if (ds->fd >= 0) close(ds->fd);
  delete ds;
}

// ------------------------------------------------------------------- loader --

// Bounded multi-producer prefetch loader. Worker threads claim batch indices
// in order, assemble each batch into a staging buffer, and hand completed
// buffers to the consumer through a small reorder window so batches arrive in
// deterministic order regardless of worker scheduling.

struct Batch {
  std::vector<char> buf;
  int64_t id = -1;
};

struct AtpuLoader {
  const AtpuDataset* ds = nullptr;
  int64_t batch_size = 0;
  int64_t batch_bytes = 0;
  int64_t num_batches = 0;  // per epoch
  bool drop_last = true;
  bool shuffle = false;
  uint64_t seed = 0;
  int64_t epoch = 0;

  std::vector<int64_t> order;  // shuffled record indices for current epoch

  std::vector<std::thread> workers;
  std::atomic<int64_t> next_batch{0};  // producer claim counter
  std::atomic<bool> stop{false};

  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::deque<Batch> ready;      // completed batches (reordered on pop)
  int64_t next_out = 0;         // id the consumer must receive next
  int64_t max_ready = 0;        // lookahead window (ids < next_out + max_ready)
  int32_t num_workers = 2;

  void reshuffle() {
    order.resize(ds->num_records);
    for (int64_t i = 0; i < ds->num_records; ++i) order[i] = i;
    if (shuffle) {
      std::mt19937_64 rng(seed + static_cast<uint64_t>(epoch));
      for (int64_t i = ds->num_records - 1; i > 0; --i) {
        int64_t j = static_cast<int64_t>(rng() % static_cast<uint64_t>(i + 1));
        std::swap(order[i], order[j]);
      }
    }
  }

  void work() {
    while (!stop.load(std::memory_order_acquire)) {
      int64_t id = next_batch.fetch_add(1, std::memory_order_relaxed);
      if (id >= num_batches) return;
      Batch b;
      b.id = id;
      b.buf.resize(batch_bytes);
      for (int64_t k = 0; k < batch_size; ++k) {
        // wraparound for the final uneven batch when drop_last is off
        // (reference even_batches wraparound, data_loader.py:236-262)
        int64_t pos = id * batch_size + k;
        int64_t rec = order[pos % ds->num_records];
        memcpy(b.buf.data() + k * ds->record_bytes,
               ds->data + rec * ds->record_bytes, ds->record_bytes);
      }
      std::unique_lock<std::mutex> lock(mu);
      // Admission by id, not queue occupancy: waiting on "queue has space"
      // deadlocks when out-of-order completions fill the window while the
      // consumer still needs an older id. With id-bounded lookahead every id
      // in [next_out, next_out+max_ready) is admissible, so the consumer's
      // next batch always gets in.
      cv_produce.wait(lock, [&] {
        return stop.load(std::memory_order_acquire) ||
               id < next_out + max_ready;
      });
      if (stop.load(std::memory_order_acquire)) return;
      ready.push_back(std::move(b));
      cv_consume.notify_all();
    }
  }
};

AtpuLoader* atpu_loader_new(const AtpuDataset* ds, int64_t batch_size,
                            int32_t shuffle, uint64_t seed, int32_t drop_last,
                            int32_t num_workers, int32_t prefetch_depth) {
  if (!ds || batch_size <= 0 || ds->num_records == 0) return nullptr;
  auto* ld = new AtpuLoader();
  ld->ds = ds;
  ld->batch_size = batch_size;
  ld->batch_bytes = batch_size * ds->record_bytes;
  ld->drop_last = drop_last != 0;
  ld->shuffle = shuffle != 0;
  ld->seed = seed;
  ld->num_batches = ld->drop_last
                        ? ds->num_records / batch_size
                        : (ds->num_records + batch_size - 1) / batch_size;
  ld->max_ready = prefetch_depth > 0 ? prefetch_depth : 2;
  ld->num_workers = num_workers > 0 ? num_workers : 2;
  // the lookahead window must admit one in-flight batch per worker
  if (ld->max_ready < ld->num_workers) ld->max_ready = ld->num_workers;
  ld->reshuffle();
  for (int32_t i = 0; i < ld->num_workers; ++i)
    ld->workers.emplace_back(&AtpuLoader::work, ld);
  return ld;
}

int64_t atpu_loader_num_batches(const AtpuLoader* ld) {
  return ld->num_batches;
}

// Pop the next in-order batch into dst (batch_bytes). Returns the batch id,
// or -1 when the epoch is exhausted.
int64_t atpu_loader_next(AtpuLoader* ld, void* dst) {
  if (ld->next_out >= ld->num_batches) return -1;
  std::unique_lock<std::mutex> lock(ld->mu);
  for (;;) {
    for (auto it = ld->ready.begin(); it != ld->ready.end(); ++it) {
      if (it->id == ld->next_out) {
        memcpy(dst, it->buf.data(), ld->batch_bytes);
        ld->ready.erase(it);
        ld->next_out++;
        ld->cv_produce.notify_all();  // window advanced — admit new ids
        return ld->next_out - 1;
      }
    }
    ld->cv_consume.wait(lock);
  }
}

// Start the next epoch: reshuffles (seed+epoch) and restarts the workers.
void atpu_loader_next_epoch(AtpuLoader* ld) {
  // drain workers
  ld->stop.store(true, std::memory_order_release);
  ld->cv_produce.notify_all();
  for (auto& th : ld->workers) th.join();
  ld->workers.clear();
  ld->stop.store(false, std::memory_order_release);
  ld->ready.clear();
  ld->next_out = 0;
  ld->next_batch.store(0, std::memory_order_relaxed);
  ld->epoch += 1;
  ld->reshuffle();
  for (int32_t i = 0; i < ld->num_workers; ++i)
    ld->workers.emplace_back(&AtpuLoader::work, ld);
}

void atpu_loader_free(AtpuLoader* ld) {
  if (!ld) return;
  ld->stop.store(true, std::memory_order_release);
  ld->cv_produce.notify_all();
  ld->cv_consume.notify_all();
  for (auto& th : ld->workers) th.join();
  delete ld;
}

int32_t atpu_abi_version() { return 1; }

}  // extern "C"
