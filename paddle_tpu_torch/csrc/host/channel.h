// CSP bounded channel of byte buffers (capability parity with the
// reference's paddle/fluid/framework/channel.h typed Channel<T> — here the
// payload is opaque bytes; Python wraps with pickle).
//
// capacity > 0: buffered; send blocks when full.
// capacity == 0: rendezvous; send blocks until a receiver consumes.
// Close wakes all waiters; recv drains remaining items then reports closed.
#pragma once

#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <string>

namespace ptnative {

class ByteChannel {
 public:
  explicit ByteChannel(int64_t capacity) : cap_(capacity), closed_(false) {}

  // returns true on success, false if the channel is (or becomes) closed
  bool Send(std::string data) {
    std::unique_lock<std::mutex> lk(mu_);
    if (cap_ > 0) {
      send_cv_.wait(lk, [this] {
        return closed_ || static_cast<int64_t>(q_.size()) < cap_;
      });
      if (closed_) return false;
      q_.push_back(std::move(data));
      recv_cv_.notify_one();
      return true;
    }
    if (closed_) return false;  // never enqueue into a closed channel
    // rendezvous: enqueue, then wait until a receiver pops it
    uint64_t my_seq = ++send_seq_;
    q_.push_back(std::move(data));
    recv_cv_.notify_one();
    send_cv_.wait(lk, [this, my_seq] { return closed_ || pop_seq_ >= my_seq; });
    // closed before handoff: the item may still be drained by receivers;
    // report success only if it was actually consumed
    return pop_seq_ >= my_seq;
  }

  // returns true with *out filled; false = closed and drained
  bool Recv(std::string* out) {
    std::unique_lock<std::mutex> lk(mu_);
    ++recv_waiting_;
    recv_cv_.wait(lk, [this] { return closed_ || !q_.empty(); });
    --recv_waiting_;
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    ++pop_seq_;
    send_cv_.notify_all();
    return true;
  }

  // 1 = sent, 0 = would block, -1 = closed. For rendezvous channels a
  // try-send succeeds only when a receiver is already waiting.
  int TrySend(std::string data) {
    std::lock_guard<std::mutex> lk(mu_);
    if (closed_) return -1;
    if (cap_ > 0) {
      if (static_cast<int64_t>(q_.size()) >= cap_) return 0;
      q_.push_back(std::move(data));
      recv_cv_.notify_one();
      return 1;
    }
    if (recv_waiting_ > static_cast<int64_t>(q_.size())) {
      ++send_seq_;  // a waiting receiver will bump pop_seq_ when it takes it
      q_.push_back(std::move(data));
      recv_cv_.notify_one();
      return 1;
    }
    return 0;
  }

  // 1 = received, 0 = would block, -1 = closed and drained
  int TryRecv(std::string* out) {
    std::lock_guard<std::mutex> lk(mu_);
    if (!q_.empty()) {
      *out = std::move(q_.front());
      q_.pop_front();
      ++pop_seq_;
      send_cv_.notify_all();
      return 1;
    }
    return closed_ ? -1 : 0;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    send_cv_.notify_all();
    recv_cv_.notify_all();
  }

  bool closed() {
    std::lock_guard<std::mutex> lk(mu_);
    return closed_;
  }

  size_t size() {
    std::lock_guard<std::mutex> lk(mu_);
    return q_.size();
  }

 private:
  const int64_t cap_;
  bool closed_;
  std::deque<std::string> q_;
  uint64_t send_seq_ = 0;  // sequence numbers implement rendezvous handoff
  uint64_t pop_seq_ = 0;
  int64_t recv_waiting_ = 0;
  std::mutex mu_;
  std::condition_variable send_cv_, recv_cv_;
};

}  // namespace ptnative
