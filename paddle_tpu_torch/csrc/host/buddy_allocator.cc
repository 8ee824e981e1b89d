// Buddy allocator over a host arena.
//
// Capability parity with the reference's
// paddle/fluid/memory/detail/buddy_allocator.h:33 (buddy system over chunks
// from a SystemAllocator). Device memory is PyTorch's caching allocator's,
// so the native allocator's role here is the *host* staging side: aligned
// buffers for input pipelines and checkpoint IO, with O(log n)
// alloc/free and coalescing — metadata kept out-of-band like the
// reference's MetadataCache (detail/meta_cache.cc).

#include <cstdint>
#include <cstdlib>
#include <map>
#include <mutex>
#include <set>
#include <vector>

namespace {

struct Alloc {
  int level;
  uint64_t requested;  // bytes the caller asked for (guard starts after)
};

// Guard bytes: the slack between the requested size and the (power-of-two)
// block is stamped with a canary on alloc and verified on free/check —
// the role of the reference's MetadataCache guard fields
// (memory/detail/memory_block_desc.cc checksums, meta_cache.cc).
constexpr unsigned char kGuardByte = 0xAB;
constexpr uint64_t kGuardMax = 16;  // stamp at most this many slack bytes
constexpr uint64_t kGuardMin = 8;   // always reserve at least this much

struct Buddy {
  unsigned char* arena = nullptr;
  uint64_t total = 0;       // power of two
  uint64_t min_block = 0;   // power of two
  bool guard_always = false;  // bump blocks so every alloc has a guard
  int levels = 0;           // level 0 = whole arena
  // free offsets per level; allocated offset -> alloc record
  std::vector<std::set<uint64_t>> free_lists;
  std::map<uint64_t, Alloc> allocated;
  uint64_t used = 0;
  uint64_t quarantined = 0;  // bytes held out after guard corruption
  std::mutex mu;

  uint64_t block_size(int level) const { return total >> level; }

  uint64_t guard_len(const Alloc& a) const {
    uint64_t slack = block_size(a.level) - a.requested;
    return slack < kGuardMax ? slack : kGuardMax;
  }

  void stamp(uint64_t off, const Alloc& a) {
    uint64_t n = guard_len(a);
    unsigned char* g = arena + off + a.requested;
    for (uint64_t i = 0; i < n; ++i) g[i] = kGuardByte;
  }

  bool intact(uint64_t off, const Alloc& a) const {
    uint64_t n = guard_len(a);
    const unsigned char* g = arena + off + a.requested;
    for (uint64_t i = 0; i < n; ++i)
      if (g[i] != kGuardByte) return false;
    return true;
  }
};

uint64_t next_pow2(uint64_t v) {
  uint64_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// guard_mode: 0 = guards only in natural slack (zero capacity overhead;
// exact power-of-two requests go unguarded), 1 = always guard (requests
// within kGuardMin of a power of two bump one block level — full coverage
// at up to 2x block cost for those sizes). The capacity trade-off is the
// caller's call, so it's a create-time knob.
void* pt_buddy_create(uint64_t total_bytes, uint64_t min_block,
                      int guard_mode) {
  if (total_bytes == 0) return nullptr;
  auto* b = new Buddy();
  b->guard_always = guard_mode != 0;
  b->total = next_pow2(total_bytes);
  b->min_block = next_pow2(min_block ? min_block : 256);
  if (b->min_block > b->total) b->min_block = b->total;
  b->levels = 0;
  for (uint64_t s = b->total; s > b->min_block; s >>= 1) b->levels++;
  b->free_lists.resize(b->levels + 1);
  if (posix_memalign(reinterpret_cast<void**>(&b->arena), 4096, b->total)) {
    delete b;
    return nullptr;
  }
  b->free_lists[0].insert(0);
  return b;
}

void* pt_buddy_alloc(void* bp, uint64_t size) {
  auto* b = static_cast<Buddy*>(bp);
  if (size == 0 || size > b->total) return nullptr;
  uint64_t want = next_pow2(size < b->min_block ? b->min_block : size);
  // guard_always: reserve guard space even for exact power-of-two sizes
  // by bumping one block level (whole-arena requests stay guardless —
  // there's nowhere to put the guard)
  if (b->guard_always && want - size < kGuardMin && want < b->total)
    want <<= 1;
  int level = 0;
  while (b->block_size(level) > want && level < b->levels) level++;
  if (b->block_size(level) < want) level--;

  std::lock_guard<std::mutex> lk(b->mu);
  // find the lowest level <= target with a free block
  int l = level;
  while (l >= 0 && b->free_lists[l].empty()) l--;
  if (l < 0) return nullptr;
  uint64_t off = *b->free_lists[l].begin();
  b->free_lists[l].erase(b->free_lists[l].begin());
  // split down to the target level
  while (l < level) {
    l++;
    uint64_t buddy_off = off + b->block_size(l);
    b->free_lists[l].insert(buddy_off);
  }
  Alloc rec{level, size};
  b->allocated[off] = rec;
  b->used += b->block_size(level);
  b->stamp(off, rec);
  return b->arena + off;
}

int pt_buddy_free(void* bp, void* p) {
  auto* b = static_cast<Buddy*>(bp);
  uint64_t off = static_cast<unsigned char*>(p) - b->arena;
  std::lock_guard<std::mutex> lk(b->mu);
  auto it = b->allocated.find(off);
  if (it == b->allocated.end()) return -1;  // double free / bad pointer
  int rc = b->intact(off, it->second) ? 0 : -2;  // -2 = overwrite detected
  int level = it->second.level;
  b->allocated.erase(it);
  if (rc == -2) {
    // Quarantine: a detected overwrite means unknown bytes past the block
    // may also be damaged. Keep the block out of the free lists entirely
    // (it stays "used") so it cannot be handed out again before the
    // caller's error handling runs — the allocator trades capacity for
    // containment.
    b->quarantined += b->block_size(level);
    return rc;
  }
  b->used -= b->block_size(level);
  // coalesce with buddy while possible
  while (level > 0) {
    uint64_t buddy_off = off ^ b->block_size(level);
    auto& fl = b->free_lists[level];
    auto bit = fl.find(buddy_off);
    if (bit == fl.end()) break;
    fl.erase(bit);
    off = off < buddy_off ? off : buddy_off;
    level--;
  }
  b->free_lists[level].insert(off);
  return rc;
}

// Sweep every live allocation's guard region; returns the number of
// corrupted blocks (0 = clean). The reference's meta_cache guard check.
uint64_t pt_buddy_check(void* bp) {
  auto* b = static_cast<Buddy*>(bp);
  std::lock_guard<std::mutex> lk(b->mu);
  uint64_t bad = 0;
  for (const auto& kv : b->allocated)
    if (!b->intact(kv.first, kv.second)) bad++;
  return bad;
}

uint64_t pt_buddy_quarantined(void* bp) {
  auto* b = static_cast<Buddy*>(bp);
  std::lock_guard<std::mutex> lk(b->mu);
  return b->quarantined;
}

uint64_t pt_buddy_used(void* bp) {
  auto* b = static_cast<Buddy*>(bp);
  std::lock_guard<std::mutex> lk(b->mu);
  return b->used;
}

uint64_t pt_buddy_total(void* bp) {
  return static_cast<Buddy*>(bp)->total;
}

void pt_buddy_destroy(void* bp) {
  auto* b = static_cast<Buddy*>(bp);
  free(b->arena);
  delete b;
}

}  // extern "C"
