// localqueue — native in-process message broker with SQS-shaped semantics.
//
// The port's copy of the JAX package's native/localqueue.cpp, unchanged in
// behaviour.  The controller watches AWS SQS over HTTPS; this component is
// the co-located alternative: when the queue feeding the GPU workers lives
// in the same pod or host as the producers, a microsecond-latency native
// broker replaces the managed service while keeping the exact
// attribute/receive/delete surface the rest of the stack
// (QueueMetricSource, QueueWorker) already speaks — visible / delayed /
// not-visible counts, visibility timeouts with redelivery, and
// receipt-handle deletes.
//
// Concurrency: one mutex per queue; receivers may long-poll (lq_receive
// with wait_s > 0) on a condition_variable that send/delete/visibility
// changes signal.  The Python binding (native/__init__.py) calls through
// ctypes, which releases the GIL, so worker threads block here without
// stalling the interpreter.
//
// Time: steady_clock by default; lq_use_manual_clock/lq_advance switch a
// queue to a virtual clock so tests can replay visibility-timeout
// scenarios deterministically (the same injectable-clock philosophy as
// core/clock.py).

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Msg {
  long long id;
  std::string body;
};

struct Delayed {
  double ready_at;
  Msg msg;
};

struct Inflight {
  double deadline;
  Msg msg;
};

double real_now() {
  using namespace std::chrono;
  return duration<double>(steady_clock::now().time_since_epoch()).count();
}

}  // namespace

struct LocalQueue {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Msg> visible;
  std::vector<Delayed> delayed;
  std::unordered_map<long long, Inflight> inflight;
  long long next_msg_id = 0;
  long long next_receipt = 0;
  double visibility_timeout = 30.0;
  bool manual_clock = false;
  double manual_now = 0.0;
  // shutdown handshake: lq_destroy flips `closing`, wakes long-pollers,
  // and waits for `waiters` to drain before deleting (destroying a mutex
  // or condvar another thread is blocked on is undefined behavior)
  bool closing = false;
  int waiters = 0;

  double now() const { return manual_clock ? manual_now : real_now(); }

  // Move due delayed messages and expired in-flight messages back to
  // visible.  Expired receipts are re-queued in receipt order so
  // redelivery is deterministic.  Caller holds mu.
  void settle() {
    const double t = now();
    for (auto it = delayed.begin(); it != delayed.end();) {
      if (it->ready_at <= t) {
        visible.push_back(std::move(it->msg));
        it = delayed.erase(it);
      } else {
        ++it;
      }
    }
    std::vector<long long> expired;
    for (const auto& kv : inflight) {
      if (kv.second.deadline <= t) expired.push_back(kv.first);
    }
    std::sort(expired.begin(), expired.end());
    for (long long receipt : expired) {
      visible.push_back(std::move(inflight[receipt].msg));
      inflight.erase(receipt);
    }
    if (!expired.empty()) cv.notify_all();
  }
};

extern "C" {

LocalQueue* lq_create(double visibility_timeout_s) {
  auto* q = new LocalQueue();
  q->visibility_timeout = visibility_timeout_s;
  return q;
}

// Begin shutdown without freeing: mark the queue closing and wake
// long-pollers so they return promptly (-1).  The Python binding calls
// this first, then waits for its own active-call refcount to drain, then
// calls lq_destroy — so no thread can be inside the object when it is
// freed, even threads that had already passed the binding's handle check
// but not yet entered the C function.
void lq_close(LocalQueue* q) {
  if (q == nullptr) return;
  std::lock_guard<std::mutex> lock(q->mu);
  q->closing = true;
  q->cv.notify_all();
}

// Safe even with receivers blocked in lq_receive's long poll: wakes them,
// waits for them to leave the queue's mutex/condvar, then deletes.  The
// caller must still prevent *new* calls after destroy begins AND ensure
// no thread is still executing any lq_* entry on this queue (the Python
// binding's refcount in close() guarantees both).
void lq_destroy(LocalQueue* q) {
  if (q == nullptr) return;
  {
    std::unique_lock<std::mutex> lock(q->mu);
    q->closing = true;
    q->cv.notify_all();
    q->cv.wait(lock, [q] { return q->waiters == 0; });
  }
  delete q;
}

void lq_use_manual_clock(LocalQueue* q, int enable) {
  std::lock_guard<std::mutex> lock(q->mu);
  q->manual_clock = enable != 0;
}

void lq_advance(LocalQueue* q, double seconds) {
  {
    std::lock_guard<std::mutex> lock(q->mu);
    q->manual_now += seconds;
    q->settle();
  }
  q->cv.notify_all();
}

// Enqueue; delay_s > 0 parks the message as "delayed" first (SQS
// DelaySeconds).  Returns the message id.
long long lq_send(LocalQueue* q, const char* body, long long len,
                  double delay_s) {
  long long id;
  {
    std::lock_guard<std::mutex> lock(q->mu);
    id = ++q->next_msg_id;
    Msg m{id, std::string(body, static_cast<size_t>(len))};
    if (delay_s > 0.0) {
      q->delayed.push_back(Delayed{q->now() + delay_s, std::move(m)});
    } else {
      q->visible.push_back(std::move(m));
    }
  }
  q->cv.notify_one();
  return id;
}

// Pop one visible message into in-flight.  Blocks up to wait_s for a
// message (long polling; no blocking under the manual clock — virtual
// time only moves via lq_advance).  On success returns 0 and fills
// receipt_out/len_out; returns -1 if no message became visible in time.
int lq_receive(LocalQueue* q, double wait_s, long long* receipt_out,
               long long* len_out) {
  std::unique_lock<std::mutex> lock(q->mu);
  q->settle();
  if (q->visible.empty() && wait_s > 0.0 && !q->manual_clock &&
      !q->closing) {
    const auto deadline =
        std::chrono::steady_clock::now() +
        std::chrono::duration_cast<std::chrono::steady_clock::duration>(
            std::chrono::duration<double>(wait_s));
    // slice the wait so lazily-settled delayed/expired messages surface
    // without a dedicated timer thread
    ++q->waiters;
    while (q->visible.empty() && !q->closing &&
           std::chrono::steady_clock::now() < deadline) {
      q->cv.wait_for(lock, std::chrono::milliseconds(10));
      q->settle();
    }
    --q->waiters;
    q->cv.notify_all();  // let a pending lq_destroy proceed
  }
  if (q->closing || q->visible.empty()) return -1;
  Msg m = std::move(q->visible.front());
  q->visible.pop_front();
  const long long receipt = ++q->next_receipt;
  const long long len = static_cast<long long>(m.body.size());
  q->inflight.emplace(receipt,
                      Inflight{q->now() + q->visibility_timeout, std::move(m)});
  *receipt_out = receipt;
  *len_out = len;
  return 0;
}

// Copy the body of an in-flight receipt (it stays in-flight until deleted
// or expired).  Returns bytes copied, or -1 for an unknown receipt.
long long lq_fetch_body(LocalQueue* q, long long receipt, char* buf,
                        long long cap) {
  std::lock_guard<std::mutex> lock(q->mu);
  auto it = q->inflight.find(receipt);
  if (it == q->inflight.end()) return -1;
  const std::string& body = it->second.msg.body;
  const long long n = std::min<long long>(cap, body.size());
  std::memcpy(buf, body.data(), static_cast<size_t>(n));
  return n;
}

// Ack: drop an in-flight message for good.  0 on success, -1 if the
// receipt is unknown (already deleted or redelivered after expiry).
int lq_delete(LocalQueue* q, long long receipt) {
  std::lock_guard<std::mutex> lock(q->mu);
  return q->inflight.erase(receipt) ? 0 : -1;
}

// SQS ChangeMessageVisibility: reset an in-flight deadline (0 returns the
// message to visible immediately).  0 on success, -1 unknown receipt.
int lq_change_visibility(LocalQueue* q, long long receipt, double timeout_s) {
  std::lock_guard<std::mutex> lock(q->mu);
  auto it = q->inflight.find(receipt);
  if (it == q->inflight.end()) return -1;
  it->second.deadline = q->now() + timeout_s;
  q->settle();
  q->cv.notify_all();
  return 0;
}

// out[0]=visible, out[1]=delayed, out[2]=not-visible (in-flight) — the
// three default attributes the controller sums (sqs/sqs.go:28-33).
void lq_attributes(LocalQueue* q, long long out[3]) {
  std::lock_guard<std::mutex> lock(q->mu);
  q->settle();
  out[0] = static_cast<long long>(q->visible.size());
  out[1] = static_cast<long long>(q->delayed.size());
  out[2] = static_cast<long long>(q->inflight.size());
}

}  // extern "C"
