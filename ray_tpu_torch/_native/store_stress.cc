// Thread stress harness for the shm object store, built with -fsanitize=thread
// by the test suite (reference: the bazel --config=tsan builds that gate
// src/ray/object_manager/plasma/ in upstream CI, SURVEY §5).
//
// Spawns N threads against one segment doing create/seal/get/release/delete
// with eviction pressure (arena sized to ~1/4 of the working set), then
// verifies every surviving object's payload bytes.

#include "object_store.cc"

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

void fill_id(uint8_t* id, uint64_t thread_id, uint64_t i) {
  memset(id, 0, kIdLen);
  memcpy(id, &thread_id, sizeof(thread_id));
  memcpy(id + 8, &i, sizeof(i));
}

std::atomic<uint64_t> g_errors{0};

void worker(int64_t h, uint64_t thread_id, int iters) {
  uint8_t id[kIdLen];
  for (int i = 0; i < iters; ++i) {
    uint64_t key = (uint64_t)(i % 64);
    fill_id(id, thread_id, key);
    uint64_t size = 256 + (i % 7) * 1024;
    int64_t off = rts_obj_create2(h, id, size, /*allow_evict=*/1);
    if (off >= 0) {
      uint8_t* p = rts_base(h) + off;
      memset(p, (int)(key & 0xff), size);
      if (rts_obj_seal(h, id) < 0) g_errors.fetch_add(1);
    } else if (off != -4 && off != -2) {
      g_errors.fetch_add(1);
    }
    // read-verify a random earlier object from ANY thread
    fill_id(id, (thread_id + i) % 4, (uint64_t)((i * 13) % 64));
    uint64_t got_size = 0;
    int64_t goff = rts_obj_get(h, id, &got_size);
    if (goff >= 0) {
      uint8_t* p = rts_base(h) + goff;
      uint8_t expect = (uint8_t)(((i * 13) % 64) & 0xff);
      for (uint64_t j = 0; j < got_size; j += 997) {
        if (p[j] != expect) {
          g_errors.fetch_add(1);
          break;
        }
      }
      rts_obj_release(h, id);
    }
    if (i % 17 == 0) {
      fill_id(id, thread_id, (uint64_t)(i % 64));
      rts_obj_delete(h, id);
    }
    if (i % 31 == 0) rts_evict(h, 8192);
  }
}

}  // namespace

int main(int argc, char** argv) {
  const char* name = argc > 1 ? argv[1] : "/rts_stress";
  int n_threads = argc > 2 ? atoi(argv[2]) : 4;
  int iters = argc > 3 ? atoi(argv[3]) : 20000;
  shm_unlink(name);
  int64_t h = rts_create(name, 1 << 20, 1024);
  if (h < 0) {
    fprintf(stderr, "create failed: %lld\n", (long long)h);
    return 2;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t)
    threads.emplace_back(worker, h, (uint64_t)t, iters);
  for (auto& th : threads) th.join();
  shm_unlink(name);
  if (g_errors.load() != 0) {
    fprintf(stderr, "errors: %llu\n", (unsigned long long)g_errors.load());
    return 1;
  }
  printf("ok\n");
  return 0;
}
