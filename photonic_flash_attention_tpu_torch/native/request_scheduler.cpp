// Native request scheduler for the continuous-batching serving engine.
//
// A copy of the JAX package's native/request_scheduler.cpp: a priority
// admission queue, FIFO within a priority, higher priority first, with
// per-request wait accounting. One change: pfa_sched_pop removes the
// request wherever it sits in its queue, as core/native_sched.py's Python
// scheduler does, so best-fit admission (which admits from behind the head)
// never admits a request twice.
//
// C ABI, bound via ctypes (core/native_sched.py), built with g++ into the
// package's _build/ at first use. No external deps.

#include <algorithm>
#include <cstdint>
#include <deque>
#include <map>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Scheduler {
  std::mutex mu;
  // priority -> FIFO of seq ids; iterate highest priority first.
  std::map<int32_t, std::deque<int64_t>, std::greater<int32_t>> queues;
  std::unordered_map<int64_t, int64_t> submit_us;  // waiting ids -> enqueue time
  std::unordered_map<int64_t, int32_t> prio;       // waiting ids -> priority
  // wait-time history ring (microseconds) for percentile stats.
  std::vector<int64_t> waits;
  size_t wait_pos = 0;
  static constexpr size_t kWaitCap = 512;
  int64_t admitted = 0;
  int64_t cancelled = 0;

  void record_wait(int64_t us) {
    if (waits.size() < kWaitCap) {
      waits.push_back(us);
    } else {
      waits[wait_pos] = us;
      wait_pos = (wait_pos + 1) % kWaitCap;
    }
  }
};

int64_t percentile(std::vector<int64_t> v, double p) {
  if (v.empty()) return 0;
  std::sort(v.begin(), v.end());
  size_t idx = static_cast<size_t>(p * (v.size() - 1));
  return v[idx];
}

}  // namespace

extern "C" {

void* pfa_sched_create() { return new Scheduler(); }

void pfa_sched_destroy(void* h) { delete static_cast<Scheduler*>(h); }

// Enqueue a request. FIFO within a priority level; higher priority first.
void pfa_sched_submit(void* h, int64_t sid, int32_t priority, int64_t now_us) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->queues[priority].push_back(sid);
  s->submit_us[sid] = now_us;
  s->prio[sid] = priority;
}

// Highest-priority FIFO head, or -1 when empty. Does not dequeue.
int64_t pfa_sched_peek(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  for (auto& [p, q] : s->queues) {
    if (!q.empty()) return q.front();
  }
  return -1;
}

// Dequeue an admitted request wherever it sits; records its wait time.
// Returns 0 on success, -1 if sid is not waiting.
int32_t pfa_sched_pop(void* h, int64_t sid, int64_t now_us) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  auto pit = s->prio.find(sid);
  if (pit == s->prio.end()) return -1;
  auto& q = s->queues[pit->second];
  auto qit = std::find(q.begin(), q.end(), sid);
  if (qit != q.end()) q.erase(qit);
  s->prio.erase(pit);
  auto it = s->submit_us.find(sid);
  if (it != s->submit_us.end()) {
    s->record_wait(now_us - it->second);
    s->submit_us.erase(it);
  }
  s->admitted++;
  return 0;
}

// Remove a waiting request wherever it sits. Returns 0 if found.
int32_t pfa_sched_cancel(void* h, int64_t sid) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  auto pit = s->prio.find(sid);
  if (pit == s->prio.end()) return -1;
  auto& q = s->queues[pit->second];
  auto qit = std::find(q.begin(), q.end(), sid);
  if (qit != q.end()) q.erase(qit);
  s->prio.erase(pit);
  s->submit_us.erase(sid);
  s->cancelled++;
  return 0;
}

int64_t pfa_sched_count(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  int64_t n = 0;
  for (auto& [p, q] : s->queues) n += static_cast<int64_t>(q.size());
  return n;
}

// Copy waiting ids in dequeue order into out (cap entries); returns count.
int64_t pfa_sched_waiting(void* h, int64_t* out, int64_t cap) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  int64_t n = 0;
  for (auto& [p, q] : s->queues) {
    for (int64_t sid : q) {
      if (n >= cap) return n;
      out[n++] = sid;
    }
  }
  return n;
}

// out[6] = {waiting, admitted, cancelled, wait_p50_us, wait_p95_us, wait_max_us}
void pfa_sched_stats(void* h, int64_t* out) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  int64_t waiting = 0;
  for (auto& [p, q] : s->queues) waiting += static_cast<int64_t>(q.size());
  out[0] = waiting;
  out[1] = s->admitted;
  out[2] = s->cancelled;
  out[3] = percentile(s->waits, 0.5);
  out[4] = percentile(s->waits, 0.95);
  out[5] = s->waits.empty()
               ? 0
               : *std::max_element(s->waits.begin(), s->waits.end());
}

}  // extern "C"
