// C ABI over ByteChannel (reference framework/channel.h Channel<T> +
// operators/concurrency/channel_util.cc — CSP primitives for Go-style
// pipelines; paddle_tpu_torch.native.channel wraps these via ctypes).

#include <cstdint>
#include <cstdlib>
#include <cstring>

#include "channel.h"

extern "C" {

void* pt_chan_create(int64_t capacity) {
  return new ptnative::ByteChannel(capacity);
}

// 0 = ok, -1 = channel closed
int pt_chan_send(void* cp, const char* data, uint64_t len) {
  auto* c = static_cast<ptnative::ByteChannel*>(cp);
  return c->Send(std::string(data, len)) ? 0 : -1;
}

// returns length and malloc'd *out (caller frees with pt_buf_free);
// -1 = closed and drained
int64_t pt_chan_recv(void* cp, char** out) {
  auto* c = static_cast<ptnative::ByteChannel*>(cp);
  std::string s;
  if (!c->Recv(&s)) return -1;
  *out = static_cast<char*>(malloc(s.size() ? s.size() : 1));
  memcpy(*out, s.data(), s.size());
  return static_cast<int64_t>(s.size());
}

void pt_buf_free(char* p) { free(p); }

// 1 = sent, 0 = would block, -1 = closed
int pt_chan_try_send(void* cp, const char* data, uint64_t len) {
  auto* c = static_cast<ptnative::ByteChannel*>(cp);
  return c->TrySend(std::string(data, len));
}

// length >= 0 with *out filled, -2 = would block, -1 = closed and drained
int64_t pt_chan_try_recv(void* cp, char** out) {
  auto* c = static_cast<ptnative::ByteChannel*>(cp);
  std::string s;
  int rc = c->TryRecv(&s);
  if (rc == 0) return -2;
  if (rc < 0) return -1;
  *out = static_cast<char*>(malloc(s.size() ? s.size() : 1));
  memcpy(*out, s.data(), s.size());
  return static_cast<int64_t>(s.size());
}

void pt_chan_close(void* cp) {
  static_cast<ptnative::ByteChannel*>(cp)->Close();
}

int64_t pt_chan_size(void* cp) {
  return static_cast<int64_t>(static_cast<ptnative::ByteChannel*>(cp)->size());
}

void pt_chan_destroy(void* cp) {
  delete static_cast<ptnative::ByteChannel*>(cp);
}

}  // extern "C"
