// Native page allocator for the paged KV-cache pool.
//
// A copy of the JAX package's native/page_allocator.cpp. The serving
// engine's page bookkeeping (free-list pops, per-sequence page tables,
// length accounting) sits on the host between decode windows; this C++
// implementation keeps it O(1) at large pool sizes. Exposed through a plain
// C ABI consumed via ctypes (core/native_alloc.py), which builds it with
// g++ into the package's _build/ at first use. It hands out the same page
// ids, in the same order, as core/serving.py::_PyPageAllocator.

#include <cstdint>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Sequence {
  std::vector<int32_t> pages;
  int32_t length_tokens = 0;  // tokens written (informational)
};

struct Allocator {
  int32_t num_pages;
  int32_t page_size;
  int32_t max_pages_per_seq;
  int32_t reserved_pages = 0;  // trash pages excluded from accounting
  std::vector<int32_t> free_list;  // back = next page to hand out
  std::unordered_map<int64_t, Sequence> sequences;
  int64_t next_seq_id = 0;
  // stats
  int64_t alloc_count = 0;
  int64_t free_count = 0;
  int64_t oom_events = 0;
  int64_t peak_pages_used = 0;
  std::mutex mu;

  int64_t pages_used() const {
    return static_cast<int64_t>(num_pages) -
           static_cast<int64_t>(reserved_pages) -
           static_cast<int64_t>(free_list.size());
  }
};

int32_t pages_needed(const Allocator& a, int32_t tokens) {
  return (tokens + a.page_size - 1) / a.page_size;
}

// Reserve pages so that `seq` covers `total_tokens`; returns 0 on success.
int reserve_locked(Allocator* a, Sequence* seq, int32_t total_tokens) {
  int32_t need = pages_needed(*a, total_tokens) -
                 static_cast<int32_t>(seq->pages.size());
  if (need <= 0) return 0;
  if (static_cast<int32_t>(seq->pages.size()) + need > a->max_pages_per_seq) {
    return -2;  // exceeds per-sequence cap
  }
  if (need > static_cast<int32_t>(a->free_list.size())) {
    a->oom_events++;
    return -1;  // pool exhausted
  }
  for (int32_t i = 0; i < need; ++i) {
    seq->pages.push_back(a->free_list.back());
    a->free_list.pop_back();
  }
  a->alloc_count += need;
  if (a->pages_used() > a->peak_pages_used) {
    a->peak_pages_used = a->pages_used();
  }
  return 0;
}

}  // namespace

extern "C" {

// reserve_page0: reserve page 0 as a trash page (never allocated), the
// convention the serving engine uses for masked writes.
void* pfa_alloc_create(int32_t num_pages, int32_t page_size,
                       int32_t max_pages_per_seq, int32_t reserve_page0) {
  if (num_pages <= 0 || page_size <= 0 || max_pages_per_seq <= 0) {
    return nullptr;
  }
  auto* a = new Allocator();
  a->num_pages = num_pages;
  a->page_size = page_size;
  a->max_pages_per_seq = max_pages_per_seq;
  a->free_list.reserve(num_pages);
  int32_t first = reserve_page0 ? 1 : 0;
  a->reserved_pages = first;
  for (int32_t p = num_pages - 1; p >= first; --p) {
    a->free_list.push_back(p);
  }
  return a;
}

void pfa_alloc_destroy(void* handle) {
  delete static_cast<Allocator*>(handle);
}

// Returns new seq_id >= 0, or -1 (OOM) / -2 (cap) on failure.
int64_t pfa_alloc_sequence(void* handle, int32_t reserve_tokens) {
  auto* a = static_cast<Allocator*>(handle);
  std::lock_guard<std::mutex> lock(a->mu);
  Sequence seq;
  if (reserve_tokens > 0) {
    int rc = reserve_locked(a, &seq, reserve_tokens);
    if (rc != 0) {
      // roll back nothing: reserve_locked only mutates free_list on success
      return rc;
    }
  }
  int64_t id = a->next_seq_id++;
  a->sequences.emplace(id, std::move(seq));
  return id;
}

// Grow a sequence's reservation to cover new_total_tokens.
int32_t pfa_extend(void* handle, int64_t seq_id, int32_t new_total_tokens) {
  auto* a = static_cast<Allocator*>(handle);
  std::lock_guard<std::mutex> lock(a->mu);
  auto it = a->sequences.find(seq_id);
  if (it == a->sequences.end()) return -3;
  return reserve_locked(a, &it->second, new_total_tokens);
}

int32_t pfa_set_length(void* handle, int64_t seq_id, int32_t tokens) {
  auto* a = static_cast<Allocator*>(handle);
  std::lock_guard<std::mutex> lock(a->mu);
  auto it = a->sequences.find(seq_id);
  if (it == a->sequences.end()) return -3;
  it->second.length_tokens = tokens;
  return 0;
}

int32_t pfa_free_sequence(void* handle, int64_t seq_id) {
  auto* a = static_cast<Allocator*>(handle);
  std::lock_guard<std::mutex> lock(a->mu);
  auto it = a->sequences.find(seq_id);
  if (it == a->sequences.end()) return -3;
  for (int32_t p : it->second.pages) {
    a->free_list.push_back(p);
  }
  a->free_count += static_cast<int64_t>(it->second.pages.size());
  a->sequences.erase(it);
  return 0;
}

// Copy the sequence's page ids into out (capacity cap); returns count or <0.
int32_t pfa_get_pages(void* handle, int64_t seq_id, int32_t* out,
                      int32_t cap) {
  auto* a = static_cast<Allocator*>(handle);
  std::lock_guard<std::mutex> lock(a->mu);
  auto it = a->sequences.find(seq_id);
  if (it == a->sequences.end()) return -3;
  int32_t n = static_cast<int32_t>(it->second.pages.size());
  if (n > cap) return -4;
  for (int32_t i = 0; i < n; ++i) out[i] = it->second.pages[i];
  return n;
}

int32_t pfa_length(void* handle, int64_t seq_id) {
  auto* a = static_cast<Allocator*>(handle);
  std::lock_guard<std::mutex> lock(a->mu);
  auto it = a->sequences.find(seq_id);
  if (it == a->sequences.end()) return -3;
  return it->second.length_tokens;
}

// out[0..6]: pages_used, pages_free, alloc_count, free_count, oom_events,
//            peak_pages_used, num_sequences
void pfa_stats(void* handle, int64_t* out) {
  auto* a = static_cast<Allocator*>(handle);
  std::lock_guard<std::mutex> lock(a->mu);
  out[0] = a->pages_used();
  out[1] = static_cast<int64_t>(a->free_list.size());
  out[2] = a->alloc_count;
  out[3] = a->free_count;
  out[4] = a->oom_events;
  out[5] = a->peak_pages_used;
  out[6] = static_cast<int64_t>(a->sequences.size());
}

}  // extern "C"
