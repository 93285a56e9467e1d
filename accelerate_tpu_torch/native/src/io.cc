// Native checkpoint IO for accelerate-tpu.
//
// The reference's sharded-checkpoint path rides torch.distributed.checkpoint's
// C++ FileSystemWriter/Reader (SURVEY.md §2.3, fsdp_utils.py:103-414). This is
// the TPU-native equivalent: per-process shard files are written/read as raw
// chunk regions with a thread team doing pwrite/pread off the GIL, with
// per-chunk CRC32 integrity. The Python side (sharded_checkpoint.py) owns the
// format/index; this layer only moves bytes fast and checksums them.
//
// C ABI (ctypes):
//   atpu_io_write_chunks — preallocate (ftruncate) then parallel pwrite of n
//     chunks at caller-chosen offsets; emits per-chunk CRC32.
//   atpu_io_read_chunks  — parallel pread of n chunks; optional CRC verify.
// Return: 0 ok; -1 open/io failure; -2 crc mismatch (reads).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Table-driven CRC32 (IEEE, zlib-compatible). IO-bound workloads don't need
// hardware CRC; this keeps the library dependency-free.
uint32_t crc_table[256];
std::once_flag crc_once;

void crc_init() {
  // call_once: two ctypes callers can hit first use concurrently (the GIL is
  // released during the call) — a plain bool flag would race on the table
  std::call_once(crc_once, []() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc_table[i] = c;
    }
  });
}

uint32_t crc32_of(const void* data, int64_t n) {
  const unsigned char* p = static_cast<const unsigned char*>(data);
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i) c = crc_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

bool pwrite_all(int fd, const void* buf, int64_t n, int64_t off) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = pwrite(fd, p, static_cast<size_t>(n), static_cast<off_t>(off));
    if (w <= 0) return false;
    p += w; off += w; n -= w;
  }
  return true;
}

bool pread_all(int fd, void* buf, int64_t n, int64_t off) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = pread(fd, p, static_cast<size_t>(n), static_cast<off_t>(off));
    if (r <= 0) return false;
    p += r; off += r; n -= r;
  }
  return true;
}

}  // namespace

extern "C" {

int32_t atpu_io_write_chunks(const char* path, int64_t n, const void** srcs,
                             const int64_t* sizes, const int64_t* offsets,
                             uint32_t* crcs_out, int32_t num_threads) {
  crc_init();
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t end = offsets[i] + sizes[i];
    if (end > total) total = end;
  }
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) { close(fd); return -1; }
  std::atomic<int64_t> next(0);
  std::atomic<int32_t> failed(0);
  auto work = [&]() {
    int64_t i;
    while ((i = next.fetch_add(1)) < n && !failed.load()) {
      if (crcs_out) crcs_out[i] = crc32_of(srcs[i], sizes[i]);
      if (!pwrite_all(fd, srcs[i], sizes[i], offsets[i])) failed.store(1);
    }
  };
  if (num_threads <= 1 || n <= 1) {
    work();
  } else {
    std::vector<std::thread> team;
    int32_t nt = num_threads < n ? num_threads : static_cast<int32_t>(n);
    team.reserve(nt);
    for (int32_t t = 0; t < nt; ++t) team.emplace_back(work);
    for (auto& th : team) th.join();
  }
  bool ok = !failed.load() && fsync(fd) == 0;
  close(fd);
  return ok ? 0 : -1;
}

int32_t atpu_io_read_chunks(const char* path, int64_t n, void** dsts,
                            const int64_t* sizes, const int64_t* offsets,
                            const uint32_t* crcs, int32_t num_threads) {
  crc_init();
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  std::atomic<int64_t> next(0);
  std::atomic<int32_t> status(0);  // 0 ok, -1 io, -2 crc
  auto work = [&]() {
    int64_t i;
    while ((i = next.fetch_add(1)) < n && !status.load()) {
      if (!pread_all(fd, dsts[i], sizes[i], offsets[i])) { status.store(-1); return; }
      if (crcs && crc32_of(dsts[i], sizes[i]) != crcs[i]) { status.store(-2); return; }
    }
  };
  if (num_threads <= 1 || n <= 1) {
    work();
  } else {
    std::vector<std::thread> team;
    int32_t nt = num_threads < n ? num_threads : static_cast<int32_t>(n);
    team.reserve(nt);
    for (int32_t t = 0; t < nt; ++t) team.emplace_back(work);
    for (auto& th : team) th.join();
  }
  close(fd);
  return status.load();
}

}  // extern "C"
