// vdbstore — native storage engine for vector_db_tpu.
//
// The JAX framework's equivalent of the reference's persistence layer
// (reference: storage/VectorStorage.java — Jackson JSON file, write-behind
// flush every 1000 mutations, ReentrantReadWriteLock) and of the native
// save/load ABI the reference left as TODO stubs
// (native/index/HNSWIndex.cpp:535-541).
//
// Design: an append-only binary WAL (one record per mutation, CRC32-guarded)
// plus a snapshot file (header + ids + float32 matrix).  Load = read
// snapshot, then replay the WAL, stopping at the first corrupt/torn record —
// crash-consistent by construction.  Exposed as a C ABI for ctypes.
//
// Build: native/CMakeLists.txt or `make -C native` -> libvdbstore.so

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

// ---------------------------------------------------------------- crc32
uint32_t crc32_table[256];
bool crc32_init_done = []() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int j = 0; j < 8; j++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc32_table[i] = c;
  }
  return true;
}();

uint32_t crc32(const uint8_t* data, size_t len, uint32_t seed = 0xFFFFFFFFu) {
  uint32_t c = seed;
  for (size_t i = 0; i < len; i++) c = crc32_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ------------------------------------------------------------- formats
constexpr uint32_t WAL_MAGIC = 0x56444257u;   // "VDBW"
constexpr uint32_t SNAP_MAGIC = 0x56444253u;  // "VDBS"
constexpr uint32_t FORMAT_VERSION = 1;

enum RecordType : uint32_t { REC_ADD = 1, REC_DELETE = 2 };

#pragma pack(push, 1)
struct WalHeader {
  uint32_t magic;
  uint32_t version;
  uint32_t dim;
  uint32_t reserved;
};
struct RecordHeader {
  uint32_t type;
  int32_t id;
  uint32_t payload_len;  // bytes after this header, excluding crc
  uint32_t crc;          // crc of (type, id, payload)
};
struct SnapHeader {
  uint32_t magic;
  uint32_t version;
  uint32_t dim;
  uint32_t count;
  uint32_t crc;  // crc of ids+vectors payload
};
#pragma pack(pop)

// Durability policy for acknowledged mutations (see vdb_set_durability):
//   0 = buffered: user-space buffer only; durable at flush/snapshot/close.
//       (The reference's write-behind guarantee, VectorStorage.java:81.)
//   1 = flush:    fflush per append call — survives process crash (kill -9),
//       not OS crash.
//   2 = fsync:    fflush + fsync per append call — survives OS crash.
enum Durability : int32_t { DUR_BUFFERED = 0, DUR_FLUSH = 1, DUR_FSYNC = 2 };

struct Store {
  std::string dir;
  uint32_t dim = 0;
  FILE* wal = nullptr;
  std::mutex mu;
  uint64_t appended = 0;  // records appended since open/snapshot
  int32_t durability = DUR_FLUSH;

  std::string wal_path() const { return dir + "/wal.bin"; }
  std::string snap_path() const { return dir + "/snapshot.bin"; }
  std::string snap_tmp_path() const { return dir + "/snapshot.bin.tmp"; }
};

std::mutex g_mu;
std::map<int64_t, std::unique_ptr<Store>> g_stores;
std::atomic<int64_t> g_next_handle{1};

Store* get(int64_t h) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_stores.find(h);
  return it == g_stores.end() ? nullptr : it->second.get();
}

bool write_record(Store* s, uint32_t type, int32_t id, const float* payload,
                  uint32_t n_floats) {
  RecordHeader rh;
  rh.type = type;
  rh.id = id;
  rh.payload_len = n_floats * sizeof(float);
  // crc over type|id|payload
  uint32_t c = crc32(reinterpret_cast<const uint8_t*>(&rh.type), 8);
  if (n_floats)
    c = crc32(reinterpret_cast<const uint8_t*>(payload), rh.payload_len,
              c ^ 0xFFFFFFFFu);
  rh.crc = c;
  if (fwrite(&rh, sizeof(rh), 1, s->wal) != 1) return false;
  if (n_floats && fwrite(payload, sizeof(float), n_floats, s->wal) != n_floats)
    return false;
  s->appended++;
  return true;
}

// Apply the store's durability policy after an append call (one flush per
// call — batches are flushed as a group, the "small-group fflush" policy).
bool commit_appends(Store* s) {
  if (s->durability == DUR_BUFFERED) return true;
  if (fflush(s->wal) != 0) return false;
  if (s->durability >= DUR_FSYNC && fsync(fileno(s->wal)) != 0) return false;
  return true;
}

// fsync a file by path (used to make the snapshot rename durable).
bool fsync_path(const std::string& path) {
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) return false;
  bool ok = fsync(fd) == 0;
  close(fd);
  return ok;
}

}  // namespace

extern "C" {

// Open (or create) a store directory. Returns handle > 0, or 0 on failure.
int64_t vdb_open(const char* dir, uint32_t dim) {
  if (!dir || dim == 0) return 0;
  ::mkdir(dir, 0755);
  auto s = std::make_unique<Store>();
  s->dir = dir;
  s->dim = dim;

  // open WAL for append; write header if new/empty
  FILE* f = fopen(s->wal_path().c_str(), "ab+");
  if (!f) return 0;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  if (size == 0) {
    WalHeader h{WAL_MAGIC, FORMAT_VERSION, dim, 0};
    if (fwrite(&h, sizeof(h), 1, f) != 1) {
      fclose(f);
      return 0;
    }
    fflush(f);
  }
  s->wal = f;

  int64_t h = g_next_handle.fetch_add(1);
  std::lock_guard<std::mutex> lock(g_mu);
  g_stores[h] = std::move(s);
  return h;
}

// Set the durability policy (0=buffered, 1=flush, 2=fsync). Returns 1.
int32_t vdb_set_durability(int64_t h, int32_t level) {
  Store* s = get(h);
  if (!s || level < DUR_BUFFERED || level > DUR_FSYNC) return 0;
  std::lock_guard<std::mutex> lock(s->mu);
  s->durability = level;
  return 1;
}

// Append one add record. Returns 1 on success.
int32_t vdb_append_add(int64_t h, int32_t id, const float* vec) {
  Store* s = get(h);
  if (!s || !vec) return 0;
  std::lock_guard<std::mutex> lock(s->mu);
  return (write_record(s, REC_ADD, id, vec, s->dim) && commit_appends(s)) ? 1 : 0;
}

// Append a batch of adds (vectors row-major [n, dim]).  Returns the number
// of rows written; a negative value -w means w rows were written into the
// stream but the durability commit (fflush/fsync) failed — the records may
// still reach disk at close, so the caller must NOT blind-retry the batch
// (that would duplicate records); surface the degraded durability instead.
int32_t vdb_append_add_batch(int64_t h, const int32_t* ids, const float* vecs,
                             int32_t n) {
  Store* s = get(h);
  if (!s || !ids || !vecs) return 0;
  std::lock_guard<std::mutex> lock(s->mu);
  int32_t written = 0;
  for (int32_t i = 0; i < n; i++) {
    if (!write_record(s, REC_ADD, ids[i], vecs + size_t(i) * s->dim, s->dim))
      break;
    written++;
  }
  if (written && !commit_appends(s)) return -written;
  return written;
}

int32_t vdb_append_delete(int64_t h, int32_t id) {
  Store* s = get(h);
  if (!s) return 0;
  std::lock_guard<std::mutex> lock(s->mu);
  return (write_record(s, REC_DELETE, id, nullptr, 0) && commit_appends(s))
             ? 1 : 0;
}

// Flush user-space buffers; at fsync durability also syncs to stable storage.
int32_t vdb_flush(int64_t h) {
  Store* s = get(h);
  if (!s) return 0;
  std::lock_guard<std::mutex> lock(s->mu);
  if (fflush(s->wal) != 0) return 0;
  if (s->durability >= DUR_FSYNC && fsync(fileno(s->wal)) != 0) return 0;
  return 1;
}

// Write a full snapshot (ids [n], vectors [n, dim]) and truncate the WAL.
int32_t vdb_snapshot(int64_t h, const int32_t* ids, const float* vecs,
                     uint32_t n) {
  Store* s = get(h);
  if (!s) return 0;
  std::lock_guard<std::mutex> lock(s->mu);

  FILE* f = fopen(s->snap_tmp_path().c_str(), "wb");
  if (!f) return 0;
  SnapHeader sh{SNAP_MAGIC, FORMAT_VERSION, s->dim, n, 0};
  uint32_t c = crc32(reinterpret_cast<const uint8_t*>(ids), n * sizeof(int32_t));
  c = crc32(reinterpret_cast<const uint8_t*>(vecs),
            size_t(n) * s->dim * sizeof(float), c ^ 0xFFFFFFFFu);
  sh.crc = c;
  bool ok = fwrite(&sh, sizeof(sh), 1, f) == 1 &&
            (n == 0 || fwrite(ids, sizeof(int32_t), n, f) == n) &&
            (n == 0 || fwrite(vecs, sizeof(float), size_t(n) * s->dim, f) ==
                           size_t(n) * s->dim);
  if (ok && fflush(f) != 0) ok = false;
  // make the snapshot payload durable BEFORE the rename publishes it
  if (ok && s->durability >= DUR_FSYNC && fsync(fileno(f)) != 0) ok = false;
  ok = fclose(f) == 0 && ok;
  if (!ok) return 0;
  if (rename(s->snap_tmp_path().c_str(), s->snap_path().c_str()) != 0) return 0;
  // make the rename itself durable (directory entry)
  if (s->durability >= DUR_FSYNC) fsync_path(s->dir);

  // truncate WAL back to just the header
  fclose(s->wal);
  s->wal = fopen(s->wal_path().c_str(), "wb");
  if (!s->wal) return 0;
  WalHeader wh{WAL_MAGIC, FORMAT_VERSION, s->dim, 0};
  fwrite(&wh, sizeof(wh), 1, s->wal);
  fflush(s->wal);
  if (s->durability >= DUR_FSYNC) fsync(fileno(s->wal));
  s->appended = 0;
  return 1;
}

// Load: snapshot + WAL replay. Caller provides buffers of capacity max_n.
// Deleted ids are dropped; later adds of the same id win (last-write).
// Returns live count, or -1 on failure.
int32_t vdb_load(int64_t h, uint32_t max_n, int32_t* out_ids, float* out_vecs) {
  Store* s = get(h);
  if (!s || !out_ids || !out_vecs) return -1;
  std::lock_guard<std::mutex> lock(s->mu);

  std::map<int32_t, std::vector<float>> live;

  // 1. snapshot
  FILE* f = fopen(s->snap_path().c_str(), "rb");
  if (f) {
    SnapHeader sh;
    if (fread(&sh, sizeof(sh), 1, f) == 1 && sh.magic == SNAP_MAGIC &&
        sh.dim == s->dim) {
      std::vector<int32_t> ids(sh.count);
      std::vector<float> vecs(size_t(sh.count) * s->dim);
      if (fread(ids.data(), sizeof(int32_t), sh.count, f) == sh.count &&
          fread(vecs.data(), sizeof(float), vecs.size(), f) == vecs.size()) {
        uint32_t c =
            crc32(reinterpret_cast<const uint8_t*>(ids.data()),
                  sh.count * sizeof(int32_t));
        c = crc32(reinterpret_cast<const uint8_t*>(vecs.data()),
                  vecs.size() * sizeof(float), c ^ 0xFFFFFFFFu);
        if (c == sh.crc) {
          for (uint32_t i = 0; i < sh.count; i++) {
            live[ids[i]] = std::vector<float>(
                vecs.begin() + size_t(i) * s->dim,
                vecs.begin() + size_t(i + 1) * s->dim);
          }
        }
      }
    }
    fclose(f);
  }

  // 2. WAL replay — stop at the first corrupt/torn record
  fflush(s->wal);
  f = fopen(s->wal_path().c_str(), "rb");
  if (f) {
    WalHeader wh;
    if (fread(&wh, sizeof(wh), 1, f) == 1 && wh.magic == WAL_MAGIC &&
        wh.dim == s->dim) {
      for (;;) {
        RecordHeader rh;
        if (fread(&rh, sizeof(rh), 1, f) != 1) break;
        std::vector<uint8_t> payload(rh.payload_len);
        if (rh.payload_len &&
            fread(payload.data(), 1, rh.payload_len, f) != rh.payload_len)
          break;  // torn write
        uint32_t c = crc32(reinterpret_cast<const uint8_t*>(&rh.type), 8);
        if (rh.payload_len)
          c = crc32(payload.data(), rh.payload_len, c ^ 0xFFFFFFFFu);
        if (c != rh.crc) break;  // corrupt record
        if (rh.type == REC_ADD && rh.payload_len == s->dim * sizeof(float)) {
          const float* v = reinterpret_cast<const float*>(payload.data());
          live[rh.id] = std::vector<float>(v, v + s->dim);
        } else if (rh.type == REC_DELETE) {
          live.erase(rh.id);
        }
      }
    }
    fclose(f);
  }

  uint32_t count = 0;
  for (auto& kv : live) {
    if (count >= max_n) break;
    out_ids[count] = kv.first;
    memcpy(out_vecs + size_t(count) * s->dim, kv.second.data(),
           s->dim * sizeof(float));
    count++;
  }
  return static_cast<int32_t>(count);
}

// Number of live records currently recoverable (snapshot + wal).
int32_t vdb_count(int64_t h) {
  Store* s = get(h);
  if (!s) return -1;
  // cheap upper-bound probe: full load into nothing is wasteful; reuse load
  // path with a large budget.  Kept simple: callers use vdb_load directly.
  return static_cast<int32_t>(s->appended);
}

int32_t vdb_close(int64_t h) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_stores.find(h);
  if (it == g_stores.end()) return 0;
  if (it->second->wal) {
    fflush(it->second->wal);
    fclose(it->second->wal);
  }
  g_stores.erase(it);
  return 1;
}

uint32_t vdb_format_version() { return FORMAT_VERSION; }

}  // extern "C"
