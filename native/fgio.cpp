// fgio: native host-side hot loops for falcon_genome_tpu.
//
// The reference's native layer is its C++ runtime plus the external C/C++
// engines it forks (SURVEY.md §7); this extension is our equivalent for the
// host side: codec + index hot loops that feed the device kernels.
//
//   * BGZF block deflate       (replaces forked bgzip — VCFUtilsWorker)
//   * minimizer extraction     (aligner index build / query inner loop)
//   * packed op-stream RLE     (CIGAR assembly from the device traceback)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// Each entry point mirrors a pure-Python implementation that remains the
// correctness reference; tests assert byte-for-byte equivalence.
//
// Build: native/build.sh  (g++ -O3 -shared -fPIC fgio.cpp -lz)

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// BGZF
// ---------------------------------------------------------------------------

// Compress src[0..n) into a series of BGZF blocks (<=65280 payload each).
// dst must have capacity >= fg_bgzf_bound(n). Returns bytes written, or -1.
static const int64_t BGZF_BLOCK = 65280;

int64_t fg_bgzf_bound(int64_t n) {
  int64_t nblocks = (n + BGZF_BLOCK - 1) / BGZF_BLOCK;
  if (nblocks == 0) nblocks = 1;
  // worst case deflate expansion + 26 bytes header/footer per block
  return n + nblocks * (26 + 64) + n / 16 + 1024;
}

int64_t fg_bgzf_compress(const uint8_t* src, int64_t n, int level,
                         uint8_t* dst, int64_t dst_cap) {
  int64_t out = 0;
  int64_t off = 0;
  while (off < n) {
    int64_t chunk = n - off < BGZF_BLOCK ? n - off : BGZF_BLOCK;

    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
      return -1;
    std::vector<uint8_t> comp(chunk + chunk / 2 + 64);
    zs.next_in = const_cast<uint8_t*>(src + off);
    zs.avail_in = (uInt)chunk;
    zs.next_out = comp.data();
    zs.avail_out = (uInt)comp.size();
    if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
      deflateEnd(&zs);
      return -1;
    }
    int64_t clen = (int64_t)zs.total_out;
    deflateEnd(&zs);

    int64_t bsize = clen + 26;  // 18 header + data + 8 footer
    if (out + bsize > dst_cap) return -1;
    uint8_t* p = dst + out;
    // gzip header with BC extra subfield
    p[0] = 0x1f; p[1] = 0x8b; p[2] = 8; p[3] = 4;
    std::memset(p + 4, 0, 5);
    p[9] = 0xff;               // OS
    p[10] = 6; p[11] = 0;      // XLEN
    p[12] = 0x42; p[13] = 0x43; p[14] = 2; p[15] = 0;  // 'B','C',slen
    uint16_t bs16 = (uint16_t)(bsize - 1);
    p[16] = bs16 & 0xff; p[17] = bs16 >> 8;
    std::memcpy(p + 18, comp.data(), clen);
    uint32_t crc = crc32(0, src + off, (uInt)chunk);
    uint32_t isize = (uint32_t)chunk;
    std::memcpy(p + 18 + clen, &crc, 4);
    std::memcpy(p + 22 + clen, &isize, 4);
    out += bsize;
    off += chunk;
  }
  return out;
}

// Threaded BGZF: same output bytes as fg_bgzf_compress (blocks are
// independent deflate streams).  block_coffs (optional, nblocks+1 slots)
// receives each block's compressed start offset — with the fixed 65280-byte
// uncompressed block pitch this is everything needed to compute any
// record's BGZF virtual offset analytically (for .bai/.tbi building).
static int64_t bgzf_one_block(const uint8_t* src, int64_t chunk, int level,
                              std::vector<uint8_t>* out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK)
    return -1;
  std::vector<uint8_t> comp(chunk + chunk / 2 + 64);
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)chunk;
  zs.next_out = comp.data();
  zs.avail_out = (uInt)comp.size();
  if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
    deflateEnd(&zs);
    return -1;
  }
  int64_t clen = (int64_t)zs.total_out;
  deflateEnd(&zs);

  int64_t bsize = clen + 26;
  out->resize(bsize);
  uint8_t* p = out->data();
  p[0] = 0x1f; p[1] = 0x8b; p[2] = 8; p[3] = 4;
  std::memset(p + 4, 0, 5);
  p[9] = 0xff;
  p[10] = 6; p[11] = 0;
  p[12] = 0x42; p[13] = 0x43; p[14] = 2; p[15] = 0;
  uint16_t bs16 = (uint16_t)(bsize - 1);
  p[16] = bs16 & 0xff; p[17] = bs16 >> 8;
  std::memcpy(p + 18, comp.data(), clen);
  uint32_t crc = crc32(0, src, (uInt)chunk);
  uint32_t isize = (uint32_t)chunk;
  std::memcpy(p + 18 + clen, &crc, 4);
  std::memcpy(p + 22 + clen, &isize, 4);
  return bsize;
}

int64_t fg_bgzf_compress_mt(const uint8_t* src, int64_t n, int level,
                            int nthreads, uint8_t* dst, int64_t dst_cap,
                            int64_t* block_coffs) {
  int64_t nblocks = (n + BGZF_BLOCK - 1) / BGZF_BLOCK;
  if (nblocks == 0) {
    if (block_coffs) block_coffs[0] = 0;
    return 0;
  }
  if (nthreads < 1) nthreads = 1;
  if (nthreads > nblocks) nthreads = (int)nblocks;
  std::vector<std::vector<uint8_t>> blocks(nblocks);
  std::vector<int> fail(nthreads, 0);
  auto run = [&](int t) {
    for (int64_t b = t; b < nblocks; b += nthreads) {
      int64_t off = b * BGZF_BLOCK;
      int64_t chunk = std::min<int64_t>(BGZF_BLOCK, n - off);
      if (bgzf_one_block(src + off, chunk, level, &blocks[b]) < 0)
        fail[t] = 1;
    }
  };
  if (nthreads == 1) {
    run(0);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nthreads; t++) ts.emplace_back(run, t);
    for (auto& t : ts) t.join();
  }
  for (int t = 0; t < nthreads; t++)
    if (fail[t]) return -1;
  int64_t out = 0;
  for (int64_t b = 0; b < nblocks; b++) {
    if (out + (int64_t)blocks[b].size() > dst_cap) return -1;
    if (block_coffs) block_coffs[b] = out;
    std::memcpy(dst + out, blocks[b].data(), blocks[b].size());
    out += blocks[b].size();
  }
  if (block_coffs) block_coffs[nblocks] = out;
  return out;
}

// ---------------------------------------------------------------------------
// columnar BAM record encode (inverse of fg_bam_scan; must match
// io.bam._encode_record field-for-field for the supported column forms)
// ---------------------------------------------------------------------------

static int bam_reg2bin(int64_t beg, int64_t end) {
  end -= 1;
  if (beg >> 14 == end >> 14) return (int)(((1 << 15) - 1) / 7 + (beg >> 14));
  if (beg >> 17 == end >> 17) return (int)(((1 << 12) - 1) / 7 + (beg >> 17));
  if (beg >> 20 == end >> 20) return (int)(((1 << 9) - 1) / 7 + (beg >> 20));
  if (beg >> 23 == end >> 23) return (int)(((1 << 6) - 1) / 7 + (beg >> 23));
  if (beg >> 26 == end >> 26) return (int)(((1 << 3) - 1) / 7 + (beg >> 26));
  return 0;
}

// ASCII base -> 4-bit NT16 code ("=ACMGRSVTWYHKDBN", case-insensitive,
// unknown -> 15), matching io.bam._SEQ_ENC_LUT.
static uint8_t SEQ_NIB[256];
static uint8_t CODE_NIB[5] = {1, 2, 4, 8, 15};  // A C G T N
static bool seq_nib_init = []() {
  const char* nt = "=ACMGRSVTWYHKDBN";
  for (int i = 0; i < 256; i++) SEQ_NIB[i] = 15;
  for (int i = 0; i < 16; i++) {
    SEQ_NIB[(uint8_t)nt[i]] = (uint8_t)i;
    SEQ_NIB[(uint8_t)std::tolower(nt[i])] = (uint8_t)i;
  }
  return true;
}();

// fixed is the fg_bam_scan (N,12) layout: tid,pos,mapq,flag,lseq,mtid,mpos,
// tlen,ncigar,lname(no NUL),qual_star,end_pos.  perm gives the source row
// for each output slot; rec_off (N+1) gives each output record's byte
// offset (python computes it from the permuted sizes).  seq_mode: 0 = ASCII
// bases, 1 = 0..4 base codes.  qual_mode: 0 = ASCII (phred+33), 1 = raw.
void fg_bam_encode(const int32_t* fixed, const int64_t* perm, int64_t N,
                   const uint8_t* names, const int64_t* name_off,
                   const int32_t* cops, const int32_t* clens,
                   const int64_t* cig_off,
                   const uint8_t* seq, const uint8_t* qual,
                   const int64_t* seq_off, int seq_mode, int qual_mode,
                   const uint8_t* tags, const int64_t* tag_off,
                   const int64_t* tag_len,
                   const int64_t* rec_off, uint8_t* out, int nthreads) {
  auto encode_range = [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; i++) {
      int64_t r = perm ? perm[i] : i;
      const int32_t* f = fixed + r * 12;
      int32_t tid = f[0], pos = f[1], mapq = f[2], flag = f[3], lseq = f[4];
      int32_t mtid = f[5], mpos = f[6], tlen = f[7], nc = f[8];
      int32_t lname = f[9], qstar = f[10], endp = f[11];
      uint8_t* p = out + rec_off[i];
      int64_t size = rec_off[i + 1] - rec_off[i] - 4;
      std::memcpy(p, &size, 4);  // little-endian int32 (low 4 bytes)
      p += 4;
      std::memcpy(p, &tid, 4);
      std::memcpy(p + 4, &pos, 4);
      p[8] = (uint8_t)(lname + 1);
      p[9] = (uint8_t)mapq;
      int64_t beg = pos > 0 ? pos : 0;
      int64_t end = nc ? endp : (int64_t)pos + 1;
      if (end < 1) end = 1;
      uint16_t bin = (uint16_t)bam_reg2bin(beg, end);
      std::memcpy(p + 10, &bin, 2);
      uint16_t nc16 = (uint16_t)nc, flag16 = (uint16_t)flag;
      std::memcpy(p + 12, &nc16, 2);
      std::memcpy(p + 14, &flag16, 2);
      std::memcpy(p + 16, &lseq, 4);
      std::memcpy(p + 20, &mtid, 4);
      std::memcpy(p + 24, &mpos, 4);
      std::memcpy(p + 28, &tlen, 4);
      p += 32;
      std::memcpy(p, names + name_off[r], lname);
      p[lname] = 0;
      p += lname + 1;
      const int32_t* co = cops + cig_off[r];
      const int32_t* cl = clens + cig_off[r];
      for (int32_t k = 0; k < nc; k++) {
        uint32_t v = ((uint32_t)cl[k] << 4) | (uint32_t)(co[k] & 0xF);
        std::memcpy(p + 4 * k, &v, 4);
      }
      p += 4 * (int64_t)nc;
      const uint8_t* sp = seq + seq_off[r];
      if (seq_mode == 1) {
        for (int32_t k = 0; k + 1 < lseq; k += 2)
          p[k / 2] = (uint8_t)((CODE_NIB[sp[k]] << 4) | CODE_NIB[sp[k + 1]]);
        if (lseq & 1) p[(lseq - 1) / 2] = (uint8_t)(CODE_NIB[sp[lseq - 1]] << 4);
      } else {
        for (int32_t k = 0; k + 1 < lseq; k += 2)
          p[k / 2] = (uint8_t)((SEQ_NIB[sp[k]] << 4) | SEQ_NIB[sp[k + 1]]);
        if (lseq & 1) p[(lseq - 1) / 2] = (uint8_t)(SEQ_NIB[sp[lseq - 1]] << 4);
      }
      p += (lseq + 1) / 2;
      const uint8_t* qp = qual + seq_off[r];
      if (qstar) {
        std::memset(p, 0xff, lseq);
      } else if (qual_mode == 0) {
        for (int32_t k = 0; k < lseq; k++) p[k] = (uint8_t)(qp[k] - 33);
      } else {
        std::memcpy(p, qp, lseq);
      }
      p += lseq;
      if (tag_len[r] > 0) std::memcpy(p, tags + tag_off[r], tag_len[r]);
    }
  };
  if (nthreads <= 1 || N < 4096) {
    encode_range(0, N);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (N + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    int64_t i0 = t * per, i1 = std::min(N, i0 + per);
    if (i0 >= i1) break;
    ts.emplace_back(encode_range, i0, i1);
  }
  for (auto& t : ts) t.join();
}

static inline uint64_t mix64(uint64_t h);

// 64-bit content hash per name span (FNV-1a + splitmix finalizer); used to
// group records by query name without materializing strings.
void fg_hash_spans(const uint8_t* blob, const int64_t* offs,
                   const int32_t* lens, int64_t N, uint64_t* out) {
  for (int64_t i = 0; i < N; i++) {
    const uint8_t* p = blob + offs[i];
    uint64_t h = 0xcbf29ce484222325ULL;
    for (int32_t k = 0; k < lens[i]; k++) {
      h ^= p[k];
      h *= 0x100000001b3ULL;
    }
    out[i] = mix64(h);
  }
}

// ---------------------------------------------------------------------------
// FASTQ scan (must match io.fastq.iter_fastq_records + _pack semantics)
// ---------------------------------------------------------------------------

static uint8_t FQ_CODE[256];
static bool fq_code_init = []() {
  for (int i = 0; i < 256; i++) FQ_CODE[i] = 4;
  const char* b = "ACGT";
  for (int i = 0; i < 4; i++) {
    FQ_CODE[(uint8_t)b[i]] = (uint8_t)i;
    FQ_CODE[(uint8_t)std::tolower(b[i])] = (uint8_t)i;
  }
  return true;
}();

// One line: [*start, end) excluding the terminator; returns the offset
// just past the '\n' (or `n` when final && no terminator).  -1 = need
// more bytes.
static int64_t fq_line(const uint8_t* buf, int64_t off, int64_t n,
                       int final_chunk, int64_t* a, int64_t* b) {
  int64_t i = off;
  while (i < n && buf[i] != '\n') i++;
  if (i >= n && !final_chunk) return -1;
  *a = off;
  // strip trailing \r (the \n itself is excluded already)
  int64_t stop = (i < n) ? i : n;
  while (stop > off && (buf[stop - 1] == '\r')) stop--;
  *b = stop;
  return (i < n) ? i + 1 : n;
}

// Pass 0: count complete records. out[0]=n_recs, out[1]=max_seq_len,
// out[2]=consumed bytes, out[3]=total name bytes, out[4]=1 ok / 0
// malformed.
void fg_fastq_scan_sizes(const uint8_t* buf, int64_t n, int64_t max_recs,
                         int32_t final_chunk, int64_t* out5) {
  int64_t off = 0, recs = 0, maxlen = 0, namebytes = 0;
  out5[4] = 1;
  while (recs < max_recs && off < n) {
    int64_t h0, h1, s0, s1, p0, p1, q0, q1;
    int64_t o1 = fq_line(buf, off, n, final_chunk, &h0, &h1);
    if (o1 < 0) break;
    int64_t o2 = fq_line(buf, o1, n, final_chunk, &s0, &s1);
    if (o2 < 0) break;
    int64_t o3 = fq_line(buf, o2, n, final_chunk, &p0, &p1);
    if (o3 < 0) break;
    int64_t o4 = fq_line(buf, o3, n, final_chunk, &q0, &q1);
    if (o4 < 0) break;
    if (h1 <= h0 || buf[h0] != '@' || p1 <= p0 || buf[p0] != '+' ||
        (s1 - s0) != (q1 - q0)) {
      out5[4] = 0;
      break;
    }
    int64_t ne = h0 + 1;
    while (ne < h1 && buf[ne] != ' ' && buf[ne] != '\t') ne++;
    namebytes += ne - (h0 + 1);
    if (s1 - s0 > maxlen) maxlen = s1 - s0;
    recs++;
    off = o4;
  }
  out5[0] = recs;
  out5[1] = maxlen;
  out5[2] = off;
  out5[3] = namebytes;
}

// Pass 1: fill codes/quals/lens/name blob for n_recs records.
// codes/quals are (n_recs, width) row-major, pre-filled by the caller
// (codes with 4, quals with 0).  Returns consumed bytes, or -1.
int64_t fg_fastq_fill(const uint8_t* buf, int64_t n, int64_t n_recs,
                      int64_t width, int32_t phred_offset,
                      int32_t final_chunk,
                      uint8_t* codes, uint8_t* quals, int32_t* lens,
                      uint8_t* names, int32_t* name_lens) {
  int64_t off = 0, nameo = 0;
  for (int64_t r = 0; r < n_recs; r++) {
    int64_t h0, h1, s0, s1, p0, p1, q0, q1;
    int64_t o1 = fq_line(buf, off, n, final_chunk, &h0, &h1);
    int64_t o2 = fq_line(buf, o1, n, final_chunk, &s0, &s1);
    int64_t o3 = fq_line(buf, o2, n, final_chunk, &p0, &p1);
    int64_t o4 = fq_line(buf, o3, n, final_chunk, &q0, &q1);
    if (o4 < 0) return -1;
    int64_t ne = h0 + 1;
    while (ne < h1 && buf[ne] != ' ' && buf[ne] != '\t') ne++;
    int64_t nl = ne - (h0 + 1);
    std::memcpy(names + nameo, buf + h0 + 1, nl);
    name_lens[r] = (int32_t)nl;
    nameo += nl;
    int64_t L = s1 - s0;
    if (L > width) return -1;
    uint8_t* c = codes + r * width;
    uint8_t* q = quals + r * width;
    for (int64_t i = 0; i < L; i++) {
      c[i] = FQ_CODE[buf[s0 + i]];
      q[i] = (uint8_t)(buf[q0 + i] - phred_offset);
    }
    lens[r] = (int32_t)L;
    off = o4;
  }
  return off;
}

// ---------------------------------------------------------------------------
// minimizers (must match aligner._minimizers bit-for-bit)
// ---------------------------------------------------------------------------

static inline uint64_t mix64(uint64_t h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDULL;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A85EC53ULL;
  h ^= h >> 33;
  return h;
}

// Fill h/strand for k-mer start positions [p0, p1); the rolling k-mer
// state warms up from position max(0, p0 - ...): we simply start scanning
// codes at p0 (k-mer at pos needs codes[pos..pos+k)).
static void minimizer_hashes_range(const uint8_t* codes, int64_t n, int k,
                                   int64_t p0, int64_t p1, uint64_t* h,
                                   uint8_t* strand) {
  const uint64_t BAD = 0xFFFFFFFFFFFFFFFFULL;
  uint64_t fwd = 0, rc = 0;
  uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  int valid_run = 0;
  for (int64_t i = p0; i < p1 + k - 1 && i < n; i++) {
    uint8_t c = codes[i];
    if (c > 3) {
      valid_run = 0;
      fwd = 0;
      rc = 0;
    } else {
      valid_run++;
      fwd = ((fwd << 2) | c) & mask;
      rc = (rc >> 2) | ((uint64_t)(3 - c) << (2 * (k - 1)));
    }
    int64_t pos = i - k + 1;
    if (pos >= p0 && pos < p1) {
      if (valid_run >= k) {
        uint64_t fh = mix64(fwd);
        uint64_t rh = mix64(rc & mask);
        if (rh < fh) {
          h[pos] = rh;
          strand[pos] = 1;
        } else {
          h[pos] = fh;
          strand[pos] = 0;
        }
      } else {
        h[pos] = BAD;
        strand[pos] = 0;
      }
    }
  }
}

// Window argmins for window starts [s0, s1) given full h[]; emits with
// consecutive-position dedup seeded from window s0-1's argmin (exactly the
// serial scan's state at s0). Returns emitted count.
static int64_t minimizer_windows_range(const uint64_t* h,
                                       const uint8_t* strand, int w,
                                       int64_t s0, int64_t s1,
                                       uint64_t* out_hash, int64_t* out_pos,
                                       uint8_t* out_strand) {
  const uint64_t BAD = 0xFFFFFFFFFFFFFFFFULL;
  int64_t last_emitted = -1;
  if (s0 > 0) {
    int64_t best = s0 - 1;
    for (int64_t j = s0; j < s0 - 1 + w; j++)
      if (h[j] < h[best]) best = j;
    if (h[best] != BAD) last_emitted = best;
  }
  int64_t count = 0;
  for (int64_t s = s0; s < s1; s++) {
    int64_t best = s;
    for (int64_t j = s + 1; j < s + w; j++)
      if (h[j] < h[best]) best = j;
    if (best != last_emitted && h[best] != BAD) {
      out_hash[count] = h[best];
      out_pos[count] = best;
      out_strand[count] = strand[best];
      last_emitted = best;
      count++;
    }
  }
  return count;
}

// codes: 0..3 bases, 4=N. Writes up to (n-k+1) minimizer entries.
// Returns the count.  Large inputs fan the hash pass and the window pass
// over threads (output is bit-identical to the serial scan: each window
// chunk seeds its dedup state from the previous window's argmin).
// Batched minimizer extraction: one call per read batch instead of one
// ctypes round-trip per read (~17 µs each — 0.7 s per 40k-read align
// batch).  codes is a (n_reads, stride) row-major matrix; outputs are
// written at out_offs[i] (the caller's per-read capacity prefix sums,
// len n_reads+1) and out_counts[i] receives each read's count.
void fg_minimizers_batch(const uint8_t* codes, int64_t stride,
                         const int32_t* lens, int64_t n_reads,
                         int32_t k, int32_t w, const int64_t* out_offs,
                         uint64_t* out_hash, int64_t* out_pos,
                         uint8_t* out_strand, int64_t* out_counts);

int64_t fg_minimizers(const uint8_t* codes, int64_t n, int k, int w,
                      uint64_t* out_hash, int64_t* out_pos,
                      uint8_t* out_strand) {
  int64_t nk = n - k + 1;
  if (nk <= 0) return 0;
  const uint64_t BAD = 0xFFFFFFFFFFFFFFFFULL;
  std::vector<uint64_t> h(nk);
  std::vector<uint8_t> strand(nk);

  const int64_t MT_MIN = 4 << 20;
  int nthreads = 1;
  if (nk >= MT_MIN) {
    unsigned hc = std::thread::hardware_concurrency();
    nthreads = hc > 8 ? 8 : (hc ? (int)hc : 1);
  }

  if (nthreads <= 1) {
    minimizer_hashes_range(codes, n, k, 0, nk, h.data(), strand.data());
  } else {
    std::vector<std::thread> ts;
    int64_t per = (nk + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
      int64_t p0 = t * per, p1 = std::min(nk, p0 + per);
      if (p0 >= p1) break;
      ts.emplace_back(minimizer_hashes_range, codes, n, k, p0, p1,
                      h.data(), strand.data());
    }
    for (auto& t : ts) t.join();
  }

  if (nk <= w) {
    // single window: global argmin
    int64_t best = 0;
    for (int64_t i = 1; i < nk; i++)
      if (h[i] < h[best]) best = i;
    if (h[best] != BAD) {
      out_hash[0] = h[best];
      out_pos[0] = best;
      out_strand[0] = strand[best];
      return 1;
    }
    return 0;
  }

  int64_t n_win = nk - w + 1;
  if (nthreads <= 1) {
    return minimizer_windows_range(h.data(), strand.data(), w, 0, n_win,
                                   out_hash, out_pos, out_strand);
  }
  // parallel window pass into per-chunk scratch, then compact
  int64_t per = (n_win + nthreads - 1) / nthreads;
  std::vector<std::vector<uint64_t>> ch(nthreads);
  std::vector<std::vector<int64_t>> cp(nthreads);
  std::vector<std::vector<uint8_t>> cs(nthreads);
  std::vector<int64_t> cnt(nthreads, 0);
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; t++) {
    int64_t s0 = t * per, s1 = std::min(n_win, s0 + per);
    if (s0 >= s1) break;
    ch[t].resize(s1 - s0);
    cp[t].resize(s1 - s0);
    cs[t].resize(s1 - s0);
    ts.emplace_back([&, t, s0, s1]() {
      cnt[t] = minimizer_windows_range(h.data(), strand.data(), w, s0, s1,
                                       ch[t].data(), cp[t].data(),
                                       cs[t].data());
    });
  }
  for (auto& t : ts) t.join();
  int64_t count = 0;
  for (int t = 0; t < nthreads; t++) {
    if (cnt[t] == 0) continue;
    std::memcpy(out_hash + count, ch[t].data(), cnt[t] * 8);
    std::memcpy(out_pos + count, cp[t].data(), cnt[t] * 8);
    std::memcpy(out_strand + count, cs[t].data(), cnt[t]);
    count += cnt[t];
  }
  return count;
}

void fg_minimizers_batch(const uint8_t* codes, int64_t stride,
                         const int32_t* lens, int64_t n_reads,
                         int32_t k, int32_t w, const int64_t* out_offs,
                         uint64_t* out_hash, int64_t* out_pos,
                         uint8_t* out_strand, int64_t* out_counts) {
  int nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 8) nthreads = 8;
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; r++) {
      out_counts[r] = fg_minimizers(
          codes + r * stride, lens[r], k, w, out_hash + out_offs[r],
          out_pos + out_offs[r], out_strand + out_offs[r]);
    }
  };
  if (nthreads <= 1 || n_reads < 64) {
    work(0, n_reads);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n_reads + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    int64_t s0 = t * per, s1 = std::min(n_reads, s0 + per);
    if (s0 >= s1) break;
    ts.emplace_back(work, s0, s1);
  }
  for (auto& th : ts) th.join();
}

// ---------------------------------------------------------------------------
// packed op-stream RLE (must match smith_waterman._results_from_device_
// traceback applied to _unpack_ops output)
// ---------------------------------------------------------------------------

// packed: (S4rows, B) uint8, 4 biased 2-bit ops per byte (0=none, 1=M,
// 2=I, 3=D), step t of lane b at packed[(t>>2)*B + b] >> 2*(t&3).
// The device traceback emits the alignment path back-to-front, so lanes
// are RLE'd walking t = S-1 .. 0.  Per lane: leading soft clip read_start,
// path ops, trailing soft clip read_len - read_end.  Op codes SAM numeric:
// 0=M 1=I 2=D 4=S.
void fg_ops_rle_batch(const uint8_t* packed, int64_t S4rows, int64_t B,
                      int64_t S, const int32_t* read_start,
                      const int32_t* read_end, const int32_t* best,
                      const int32_t* read_lens, int32_t max_ops,
                      int32_t* out_ops, int32_t* out_lens,
                      int32_t* out_ncigar) {
  (void)S4rows;
  for (int64_t b = 0; b < B; b++) {
    int32_t* ops = out_ops + b * max_ops;
    int32_t* lens = out_lens + b * max_ops;
    int nc = 0;
    auto push = [&](int op, int len) {
      if (len <= 0) return;
      if (nc > 0 && ops[nc - 1] == op) {
        lens[nc - 1] += len;
      } else if (nc < max_ops) {
        ops[nc] = op;
        lens[nc] = len;
        nc++;
      }
    };
    int rl = read_lens[b];
    if (best[b] <= 0) {
      push(4, rl);
      out_ncigar[b] = nc;
      continue;
    }
    push(4, read_start[b]);
    for (int64_t t = S - 1; t >= 0; t--) {
      int v = (packed[(t >> 2) * B + b] >> (2 * (t & 3))) & 3;
      if (v) push(v - 1, 1);
    }
    push(4, rl - read_end[b]);
    out_ncigar[b] = nc;
  }
}

// ---------------------------------------------------------------------------
// columnar BAM record scan (must match io.bam._decode_record field-for-field)
// ---------------------------------------------------------------------------

// buf: concatenated size-prefixed BAM records (the stream after the BAM
// header).  Pass 0 sizes the outputs; pass 1 fills columns + decoded
// seq/qual ASCII + unpacked cigars.  Tags stay raw byte spans (decoded
// lazily python-side on first access).

static const char NT16[17] = "=ACMGRSVTWYHKDBN";

// out4: nrecords, total_lseq, total_cigar_ops, ok(1)/corrupt(0)
void fg_bam_scan_sizes(const uint8_t* buf, int64_t n, int64_t* out4) {
  int64_t off = 0, nrec = 0, tseq = 0, tcig = 0;
  out4[3] = 1;
  while (off + 4 <= n) {
    int32_t size;
    std::memcpy(&size, buf + off, 4);
    if (size < 32 || off + 4 + size > n) {
      out4[3] = 0;
      break;
    }
    const uint8_t* p = buf + off + 4;
    int32_t l_name = p[8];
    uint16_t n_cigar;
    std::memcpy(&n_cigar, p + 12, 2);
    int32_t l_seq;
    std::memcpy(&l_seq, p + 16, 4);
    (void)l_name;
    nrec++;
    tseq += l_seq;
    tcig += n_cigar;
    off += 4 + size;
  }
  out4[0] = nrec;
  out4[1] = tseq;
  out4[2] = tcig;
}

// fixed (N,12) int32: tid,pos,mapq,flag,lseq,mtid,mpos,tlen,ncigar,
//                     lname-1, qual_star, end_pos(0-based excl; pos+1 if
//                     no ref-consuming ops)
// offs  (N,4)  int64: qname_off(buf), tag_off(buf), tag_len, seq_out_off
// cig_off (N,) int64 prefix offsets into cigar_ops/cigar_lens
void fg_bam_scan(const uint8_t* buf, int64_t n,
                 int32_t* fixed, int64_t* offs, int64_t* cig_off,
                 int32_t* cigar_ops, int32_t* cigar_lens,
                 uint8_t* seq_ascii, uint8_t* qual_ascii) {
  int64_t off = 0, rec = 0, seq_out = 0, cig_out = 0;
  while (off + 4 <= n) {
    int32_t size;
    std::memcpy(&size, buf + off, 4);
    if (size < 32 || off + 4 + size > n) break;
    const uint8_t* p = buf + off + 4;
    int32_t tid, pos, l_seq, mtid, mpos, tlen;
    std::memcpy(&tid, p, 4);
    std::memcpy(&pos, p + 4, 4);
    int32_t l_name = p[8];
    int32_t mapq = p[9];
    uint16_t n_cigar, flag;
    std::memcpy(&n_cigar, p + 12, 2);
    std::memcpy(&flag, p + 14, 2);
    std::memcpy(&l_seq, p + 16, 4);
    std::memcpy(&mtid, p + 20, 4);
    std::memcpy(&mpos, p + 24, 4);
    std::memcpy(&tlen, p + 28, 4);

    int64_t qoff = off + 4 + 32;
    const uint8_t* cp = p + 32 + l_name;
    int64_t ref_len = 0;
    for (int k = 0; k < n_cigar; k++) {
      uint32_t v;
      std::memcpy(&v, cp + 4 * k, 4);
      int32_t opk = (int32_t)(v & 0xF);
      int32_t lnk = (int32_t)(v >> 4);
      cigar_ops[cig_out + k] = opk;
      cigar_lens[cig_out + k] = lnk;
      // ref-consuming: M D N = X  (0, 2, 3, 7, 8)
      if (opk == 0 || opk == 2 || opk == 3 || opk == 7 || opk == 8)
        ref_len += lnk;
    }
    const uint8_t* sp = cp + 4 * n_cigar;
    const uint8_t* qp = sp + (l_seq + 1) / 2;
    for (int64_t k = 0; k + 1 < l_seq; k += 2) {
      uint8_t b = sp[k / 2];
      seq_ascii[seq_out + k] = (uint8_t)NT16[b >> 4];
      seq_ascii[seq_out + k + 1] = (uint8_t)NT16[b & 0xF];
    }
    if (l_seq & 1)
      seq_ascii[seq_out + l_seq - 1] = (uint8_t)NT16[sp[(l_seq - 1) / 2] >> 4];
    int qual_star = (l_seq == 0) || (qp[0] == 0xff);
    for (int64_t k = 0; k < l_seq; k++)
      qual_ascii[seq_out + k] = (uint8_t)(qp[k] + 33);
    const uint8_t* tp = qp + l_seq;
    int64_t tag_off = tp - buf;
    int64_t tag_len = (off + 4 + size) - tag_off;

    int32_t* f = fixed + rec * 12;
    f[0] = tid; f[1] = pos; f[2] = mapq; f[3] = flag; f[4] = l_seq;
    f[5] = mtid; f[6] = mpos; f[7] = tlen; f[8] = n_cigar;
    f[9] = l_name - 1; f[10] = qual_star;
    f[11] = (int32_t)(pos + ref_len);
    int64_t* o = offs + rec * 4;
    o[0] = qoff; o[1] = tag_off; o[2] = tag_len; o[3] = seq_out;
    cig_off[rec] = cig_out;

    seq_out += l_seq;
    cig_out += n_cigar;
    rec++;
    off += 4 + size;
  }
}

// varlen gather: out[out_off[i] : out_off[i]+lens[i]] =
//   blob[offs[i] : offs[i]+lens[i]]  (offsets/lengths in BYTES, offs and
// lens pre-gathered by the caller for its index set).  The numpy
// equivalent (repeat + arange + fancy-index) costs ~1 s per 47 MB shard
// blob; this is a straight memcpy loop.
void fg_gather_var(const uint8_t* blob, const int64_t* offs,
                   const int64_t* lens, const int64_t* out_off,
                   int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    if (lens[i] > 0) memcpy(out + out_off[i], blob + offs[i], lens[i]);
  }
}

// ---------------------------------------------------------------------------
// local de Bruijn assembly (must match models.assembly.assemble_region
// path-for-path: same DFS order, step/path caps, dedup and selection)
// ---------------------------------------------------------------------------

}  // extern "C"

#include <algorithm>
#include <string>
#include <unordered_map>
#include <unordered_set>

namespace {

struct EdgeSet {
  // next-base counts + ref-edge bits for one (k-1)-mer node
  int32_t count[4] = {0, 0, 0, 0};
  uint8_t is_ref[4] = {0, 0, 0, 0};
};

const int64_t ASM_MAX_PATHS = 128;    // assembly.MAX_PATHS
const int64_t ASM_MAX_STEPS = 200000;

bool enumerate_paths(
    const std::unordered_map<std::string, EdgeSet>& graph,
    const std::string& source, const std::string& sink, int k,
    int64_t max_len, std::vector<std::string>* results) {
  results->clear();
  // python: stack of (node, seq); pop() LIFO; neighbors pushed ascending
  std::vector<std::string> stack;  // store seq; node = last k-1 bytes
  stack.push_back(source);
  int64_t steps = 0;
  while (!stack.empty()) {
    steps++;
    if (steps > ASM_MAX_STEPS || (int64_t)results->size() > ASM_MAX_PATHS)
      return false;
    std::string seq = std::move(stack.back());
    stack.pop_back();
    if ((int64_t)seq.size() > max_len) continue;
    std::string node = seq.substr(seq.size() - (size_t)(k - 1));
    if (node == sink && seq.size() > source.size()) {
      results->push_back(seq);
      continue;
    }
    auto it = graph.find(node);
    if (it == graph.end()) continue;
    for (int nb = 0; nb < 4; nb++) {
      if (it->second.count[nb] > 0) {
        stack.push_back(seq + (char)nb);
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// BaseRecalibrator covariate histograms in one pass over the columnar
// records (the numpy expansion materialised ~15 per-base int64 temps and
// cost ~1 µs/base; this walk runs at memory speed).  Mirrors
// bqsr.extract_covariates_columns + accumulate_table exactly — that pair
// remains the correctness reference (tests assert table equality).
//
//   fixed     (n, 12) int32 fg_bam_scan layout
//   sel       indices of eligible records (mapped primaries, qual
//             string present, tid valid — the caller's mask)
//   rg        per-SELECTED-record read-group index (len nsel)
//   seq/qual  code (0..4) and phred blobs with per-record seq_off
//   refcat    concatenated per-tid reference codes; tid_off/tid_len
//             map tid → span (tid_len 0 for absent tids)
//   known     optional per-base bitmap over refcat (1 = known site)
// Outputs are accumulated IN PLACE (caller zero-fills):
//   qual_obs/err (nrg*94), cyc_obs/err (nrg*94*512),
//   ctx_obs/err (nrg*94*16)
void fg_bqsr_hist(
    const int32_t* fixed, const int64_t* sel, int64_t nsel,
    const int32_t* rg,
    const int64_t* cig_off, const int32_t* cops, const int32_t* clens,
    const int64_t* seq_off, const uint8_t* seq, const uint8_t* qual,
    const uint8_t* refcat, int64_t ref_total,
    const int64_t* tid_off, const int64_t* tid_len,
    const uint8_t* known,
    double* qual_obs, double* qual_err,
    double* cyc_obs, double* cyc_err,
    double* ctx_obs, double* ctx_err) {
  const int MAXQ = 94, MAXC = 512, NCTX = 16, MINQ = 6;
  for (int64_t si = 0; si < nsel; si++) {
    const int64_t r = sel[si];
    const int32_t* f = fixed + r * 12;
    const int32_t tid = f[0];
    const int32_t flag = f[3];
    const int32_t lseq = f[4];
    const int32_t ncig = f[8];
    const bool rev = (flag & 0x10) != 0;
    const int64_t so = seq_off[r];
    const int64_t co = cig_off[r];
    const int64_t toff = tid_off[tid];
    const int64_t tlen = tid_len[tid];
    const int64_t qbase = (int64_t)rg[si] * MAXQ;
    int64_t qpos = 0, rpos = f[1];
    for (int32_t c = 0; c < ncig; c++) {
      const int32_t op = cops[co + c];
      const int32_t len = clens[co + c];
      if (op == 0 || op == 7 || op == 8) {          // M/=/X
        for (int32_t i = 0; i < len; i++, qpos++, rpos++) {
          const uint8_t base = seq[so + qpos];
          int32_t q = qual[so + qpos];
          if (base > 3 || q < MINQ) continue;
          if (rpos < 0 || rpos >= tlen) continue;   // outside the contig
          const int64_t gpos = toff + rpos;
          if (known && known[gpos]) continue;
          if (q >= MAXQ) q = MAXQ - 1;              // deterministic top bin
          int64_t cyc = rev ? (int64_t)lseq - 1 - qpos : qpos;
          if (cyc >= MAXC) cyc = MAXC - 1;
          const int64_t prev_i = rev ? qpos + 1 : qpos - 1;
          int32_t ctx = 0;
          if (prev_i >= 0 && prev_i < lseq) {
            const uint8_t prev = seq[so + prev_i];
            if (prev < 4) ctx = (int32_t)prev * 4 + base;
          }
          const double err = (base != refcat[gpos]) ? 1.0 : 0.0;
          const int64_t qk = qbase + q;
          qual_obs[qk] += 1.0;
          qual_err[qk] += err;
          cyc_obs[qk * MAXC + cyc] += 1.0;
          cyc_err[qk * MAXC + cyc] += err;
          ctx_obs[qk * NCTX + ctx] += 1.0;
          ctx_err[qk * NCTX + ctx] += err;
        }
      } else if (op == 1 || op == 4) {              // I/S
        qpos += len;
      } else if (op == 2 || op == 3) {              // D/N
        rpos += len;
      }                                             // H/P: nothing
    }
  }
  (void)ref_total;
}

// ApplyBQSR per-base qual rewrite through a precomputed lookup table
// (nrg, 94, 512, 16) uint8 — the additive delta model collapses to one
// gather per base.  Mirrors bqsr.apply_bqsr_columns exactly (which
// remains the correctness reference).  qual_out is a pre-copied qual
// blob; only selected records' bases are rewritten.  in/out_delta are
// 33 for ascii blobs, 0 for raw phred.
void fg_bqsr_apply(
    const int32_t* fixed, const int64_t* sel, int64_t nsel,
    const int32_t* rg, const int64_t* seq_off,
    const uint8_t* seq, const uint8_t* qual_in,
    const uint8_t* table, int32_t preserve_below,
    int32_t in_delta, int32_t out_delta, uint8_t* qual_out) {
  const int MAXQ = 94, MAXC = 512, NCTX = 16;
  for (int64_t si = 0; si < nsel; si++) {
    const int64_t r = sel[si];
    const int32_t* f = fixed + r * 12;
    const int32_t lseq = f[4];
    const bool rev = (f[3] & 0x10) != 0;
    const int64_t so = seq_off[r];
    const uint8_t* t =
        table + (int64_t)rg[si] * MAXQ * MAXC * NCTX;
    for (int32_t i = 0; i < lseq; i++) {
      int32_t q = (int32_t)qual_in[so + i] - in_delta;
      if (q < 0) q = 0;
      if (q >= MAXQ) q = MAXQ - 1;
      int32_t out;
      if (q < preserve_below) {
        out = q;
      } else {
        int64_t cyc = rev ? (int64_t)lseq - 1 - i : i;
        if (cyc >= MAXC) cyc = MAXC - 1;
        const int64_t prev_i = rev ? i + 1 : i - 1;
        int32_t ctx = 0;
        if (prev_i >= 0 && prev_i < lseq) {
          const uint8_t prev = seq[so + prev_i];
          if (prev < 4) {
            int32_t cur = seq[so + i];
            if (cur > 3) cur = 3;
            ctx = (int32_t)prev * 4 + cur;
          }
        }
        out = t[((int64_t)q * MAXC + cyc) * NCTX + ctx];
      }
      qual_out[so + i] = (uint8_t)(out + out_delta);
    }
  }
}

// Returns the number of haplotypes written (>=1; [0] is the ref), with
// *out_k the k-mer size used and *out_fallback set when assembly failed.
// out_offs has capacity max_haps+1 (prefix offsets into out_haps).
int64_t fg_assemble_region(
    const uint8_t* ref, int64_t ref_len, const uint8_t* reads,
    const int64_t* read_offs, int64_t n_reads, const int32_t* kmer_sizes,
    int32_t n_k, int32_t min_mult, int32_t max_haps, uint8_t* out_haps,
    int64_t out_cap, int64_t* out_offs, int32_t* out_k,
    int32_t* out_fallback) {
  auto emit_ref_only = [&](int k) -> int64_t {
    *out_k = k;
    *out_fallback = 1;
    out_offs[0] = 0;
    out_offs[1] = ref_len <= out_cap ? ref_len : 0;
    if (ref_len <= out_cap) std::memcpy(out_haps, ref, ref_len);
    return 1;
  };

  for (int ki = 0; ki < n_k; ki++) {
    int k = kmer_sizes[ki];
    if (ref_len <= k) break;

    std::unordered_map<std::string, EdgeSet> graph;
    graph.reserve(1024);
    auto add_seq = [&](const uint8_t* s, int64_t n, bool is_ref) {
      if (n < k) return;
      // skip k-windows containing N (code > 3), like the python `4 in`
      for (int64_t i = 0; i + k <= n; i++) {
        bool ok = true;
        for (int64_t j = i; j < i + k; j++)
          if (s[j] > 3) { ok = false; break; }
        if (!ok) continue;
        std::string node((const char*)s + i, (size_t)(k - 1));
        int nb = s[i + k - 1];
        EdgeSet& e = graph[node];
        e.count[nb]++;
        if (is_ref) e.is_ref[nb] = 1;
      }
    };
    add_seq(ref, ref_len, true);
    for (int64_t r = 0; r < n_reads; r++)
      add_seq(reads + read_offs[r], read_offs[r + 1] - read_offs[r], false);

    // prune low-multiplicity non-ref edges
    for (auto& kv : graph) {
      for (int nb = 0; nb < 4; nb++) {
        if (kv.second.count[nb] > 0 && kv.second.count[nb] < min_mult &&
            !kv.second.is_ref[nb])
          kv.second.count[nb] = 0;
      }
    }

    std::string source((const char*)ref, (size_t)(k - 1));
    std::string sink((const char*)ref + ref_len - (k - 1), (size_t)(k - 1));
    bool bad = false;
    for (char c : source) if ((uint8_t)c > 3) bad = true;
    for (char c : sink) if ((uint8_t)c > 3) bad = true;
    if (bad) break;

    std::vector<std::string> paths;
    if (!enumerate_paths(graph, source, sink, k, ref_len + 64, &paths))
      continue;  // cyclic / blowup -> larger k

    std::string refs((const char*)ref, (size_t)ref_len);
    // python: sorted(paths, key=(-support, len(s) != len(ref), s)) where
    // support = weakest non-ref edge crossed (assembly.py selection)
    auto support = [&](const std::string& s) -> int64_t {
      int64_t sup = 1LL << 30;
      for (size_t i = 0; i + k <= s.size(); i++) {
        std::string node = s.substr(i, (size_t)(k - 1));
        int nb = (uint8_t)s[i + k - 1];
        auto it = graph.find(node);
        if (it != graph.end() && !it->second.is_ref[nb])
          sup = std::min(sup, (int64_t)it->second.count[nb]);
      }
      return sup;
    };
    std::vector<int64_t> sup(paths.size());
    for (size_t i = 0; i < paths.size(); i++) sup[i] = support(paths[i]);
    std::vector<size_t> ord(paths.size());
    for (size_t i = 0; i < ord.size(); i++) ord[i] = i;
    std::stable_sort(ord.begin(), ord.end(),
                     [&](size_t ia, size_t ib) {
                       const std::string& a = paths[ia];
                       const std::string& b = paths[ib];
                       if (sup[ia] != sup[ib]) return sup[ia] > sup[ib];
                       bool da = a.size() != refs.size();
                       bool db = b.size() != refs.size();
                       if (da != db) return db;
                       return a < b;
                     });
    {
      std::vector<std::string> tmp;
      tmp.reserve(paths.size());
      for (size_t i : ord) tmp.push_back(std::move(paths[i]));
      paths.swap(tmp);
    }
    std::unordered_set<std::string> seen;
    seen.insert(refs);
    std::vector<const std::string*> haps;
    for (const auto& p : paths) {
      if ((int64_t)haps.size() + 1 >= max_haps) break;
      if (seen.count(p)) continue;
      seen.insert(p);
      haps.push_back(&p);
    }
    // write ref + selected haplotypes
    int64_t off = 0;
    out_offs[0] = 0;
    if (ref_len > out_cap) return -1;
    std::memcpy(out_haps, ref, ref_len);
    off = ref_len;
    out_offs[1] = off;
    int64_t nh = 1;
    for (const std::string* h : haps) {
      if (off + (int64_t)h->size() > out_cap) return -1;
      std::memcpy(out_haps + off, h->data(), h->size());
      off += h->size();
      out_offs[nh + 1] = off;
      nh++;
    }
    *out_k = k;
    *out_fallback = 0;
    return nh;
  }
  return emit_ref_only(kmer_sizes[n_k - 1]);
}

// Fused short-read seeding + chaining over a whole batch
// (aligner.candidate_arrays twin — that numpy path remains the
// correctness reference; tests assert candidate-for-candidate equality).
// One call replaces: batched minimizer extraction + sorted-probe index
// lookup + lexsort diagonal clustering + top-K selection (~190 ms of
// numpy per 8k-read batch at WGS scale).
//
//   codes (n_reads, stride) 0..4 base codes; lens per read
//   idx_* : the MinimizerIndex arrays (hashes ASCENDING, positions
//           uint32 global coords, strands 0/1)
//   outputs: per-read candidate slots (n_reads, max_cands) row-major —
//           gdiag/rev/nseeds/span + out_counts per read
void fg_seed_and_chain(
    const uint8_t* codes, int64_t stride, const int32_t* lens,
    int64_t n_reads, int32_t k, int32_t w,
    const uint64_t* idx_hash, const uint32_t* idx_pos,
    const uint8_t* idx_strand, int64_t idx_n,
    int32_t max_hits, int32_t diag_band, int32_t min_seeds,
    int32_t max_cands,
    int64_t* out_diag, uint8_t* out_rev, int32_t* out_nseeds,
    int64_t* out_span, int32_t* out_counts) {
  int nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 8) nthreads = 8;

  // ---- phase A: minimizers of every read (threaded) -------------------
  std::vector<int64_t> cap(n_reads + 1, 0);
  for (int64_t r = 0; r < n_reads; r++) {
    int64_t nk = (int64_t)lens[r] - k + 1;
    cap[r + 1] = cap[r] + (nk > 0 ? nk : 0);
  }
  int64_t total_cap = cap[n_reads];
  std::vector<uint64_t> mh(total_cap);
  std::vector<int64_t> mp(total_cap);
  std::vector<uint8_t> ms(total_cap);
  std::vector<int64_t> mcount(n_reads);
  {
    auto work = [&](int64_t r0, int64_t r1) {
      for (int64_t r = r0; r < r1; r++)
        mcount[r] = fg_minimizers(codes + r * stride, lens[r], k, w,
                                  mh.data() + cap[r], mp.data() + cap[r],
                                  ms.data() + cap[r]);
    };
    if (nthreads <= 1 || n_reads < 64) {
      work(0, n_reads);
    } else {
      std::vector<std::thread> ts;
      int64_t per = (n_reads + nthreads - 1) / nthreads;
      for (int t = 0; t < nthreads; t++) {
        int64_t r0 = t * per, r1 = std::min(n_reads, r0 + per);
        if (r0 >= r1) break;
        ts.emplace_back(work, r0, r1);
      }
      for (auto& th : ts) th.join();
    }
  }

  // ---- phase B: flatten + sort probes by hash -------------------------
  int64_t n_probes = 0;
  for (int64_t r = 0; r < n_reads; r++) n_probes += mcount[r];
  struct Probe { uint64_t h; int32_t rid; int32_t rp; uint8_t s; };
  std::vector<Probe> probes(n_probes);
  {
    int64_t o = 0;
    for (int64_t r = 0; r < n_reads; r++)
      for (int64_t i = 0; i < mcount[r]; i++, o++)
        probes[o] = {mh[cap[r] + i], (int32_t)r, (int32_t)mp[cap[r] + i],
                     ms[cap[r] + i]};
  }
  std::sort(probes.begin(), probes.end(),
            [](const Probe& a, const Probe& b) { return a.h < b.h; });

  // ---- phase C: merge-walk against the sorted index (galloping) -------
  // per-probe hit range [lo, lo+cnt); cnt 0 when over max_hits
  std::vector<int64_t> p_lo(n_probes), p_cnt(n_probes);
  {
    int64_t lo = 0;
    for (int64_t i = 0; i < n_probes; i++) {
      uint64_t h = probes[i].h;
      if (i > 0 && probes[i - 1].h == h) {       // duplicate probe hash
        p_lo[i] = p_lo[i - 1];
        p_cnt[i] = p_cnt[i - 1];
        lo = p_lo[i];
        continue;
      }
      // gallop forward to bracket h, then binary search
      int64_t step = 1, hi = lo;
      while (hi < idx_n && idx_hash[hi] < h) {
        lo = hi;
        hi = hi + step < idx_n ? hi + step : idx_n;
        step <<= 1;
      }
      int64_t a = std::lower_bound(idx_hash + lo, idx_hash + hi, h)
                  - idx_hash;
      int64_t b = a;
      while (b < idx_n && idx_hash[b] == h) b++;
      p_lo[i] = a;
      p_cnt[i] = (b - a) > max_hits ? 0 : (b - a);
      lo = a;
    }
  }

  // ---- phase D: scatter hits into per-read segments -------------------
  std::vector<int64_t> hcount(n_reads + 1, 0);
  for (int64_t i = 0; i < n_probes; i++)
    hcount[probes[i].rid + 1] += p_cnt[i];
  for (int64_t r = 0; r < n_reads; r++) hcount[r + 1] += hcount[r];
  int64_t n_hits = hcount[n_reads];
  struct Hit { int64_t diag; int32_t rp; uint8_t rev; };
  std::vector<Hit> hits(n_hits);
  {
    std::vector<int64_t> fill(hcount.begin(), hcount.end() - 1);
    for (int64_t i = 0; i < n_probes; i++) {
      if (!p_cnt[i]) continue;
      const Probe& p = probes[i];
      int64_t L = lens[p.rid];
      int64_t& o = fill[p.rid];
      for (int64_t j = p_lo[i]; j < p_lo[i] + p_cnt[i]; j++) {
        uint8_t rev = idx_strand[j] != p.s;
        int64_t gpos = (int64_t)idx_pos[j];
        int64_t diag = rev ? gpos - (L - k - p.rp) : gpos - (int64_t)p.rp;
        hits[o++] = {diag, p.rp, rev};
      }
    }
  }

  // ---- phase E: per-read (rev, diag) sort + band clustering + top-K ---
  struct Group { int64_t med, span; int32_t nseeds; uint8_t rev; };
  auto chain_read = [&](int64_t r) {
    out_counts[r] = 0;
    int64_t h0 = hcount[r], h1 = hcount[r + 1];
    if (h0 == h1) return;
    std::sort(hits.begin() + h0, hits.begin() + h1,
              [](const Hit& a, const Hit& b) {
                if (a.rev != b.rev) return a.rev < b.rev;
                return a.diag < b.diag;
              });
    std::vector<Group> groups;
    int64_t gs = h0;
    for (int64_t i = h0 + 1; i <= h1; i++) {
      bool brk = i == h1 || hits[i].rev != hits[gs].rev ||
                 hits[i].diag - hits[i - 1].diag > diag_band;
      if (!brk) continue;
      int64_t n = i - gs;
      if (n >= min_seeds) {
        int64_t mid_lo = gs + (n - 1) / 2, mid_hi = gs + n / 2;
        double m2 = ((double)hits[mid_lo].diag
                     + (double)hits[mid_hi].diag) / 2.0;
        int64_t med = (int64_t)std::trunc(m2);
        int32_t rp_min = hits[gs].rp, rp_max = hits[gs].rp;
        for (int64_t j = gs + 1; j < i; j++) {
          rp_min = std::min(rp_min, hits[j].rp);
          rp_max = std::max(rp_max, hits[j].rp);
        }
        groups.push_back({med, (int64_t)(rp_max - rp_min) + k,
                          (int32_t)n, hits[gs].rev});
      }
      gs = i;
    }
    if (groups.empty()) return;
    std::stable_sort(groups.begin(), groups.end(),
                     [](const Group& a, const Group& b) {
                       if (a.nseeds != b.nseeds) return a.nseeds > b.nseeds;
                       if (a.span != b.span) return a.span > b.span;
                       return a.med < b.med;
                     });
    int32_t nc = (int32_t)std::min<int64_t>(groups.size(), max_cands);
    out_counts[r] = nc;
    for (int32_t c = 0; c < nc; c++) {
      out_diag[r * max_cands + c] = groups[c].med;
      out_rev[r * max_cands + c] = groups[c].rev;
      out_nseeds[r * max_cands + c] = groups[c].nseeds;
      out_span[r * max_cands + c] = groups[c].span;
    }
  };
  if (nthreads <= 1 || n_reads < 64) {
    for (int64_t r = 0; r < n_reads; r++) chain_read(r);
  } else {
    std::vector<std::thread> ts;
    int64_t per = (n_reads + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
      int64_t r0 = t * per, r1 = std::min(n_reads, r0 + per);
      if (r0 >= r1) break;
      ts.emplace_back([&, r0, r1]() {
        for (int64_t r = r0; r < r1; r++) chain_read(r);
      });
    }
    for (auto& th : ts) th.join();
  }
}

// minimap2-class anchor chaining DP (longread.py::chain_anchors twin).
// qs/rs: anchor read/ref positions already sorted by (r, q).  Writes the
// per-anchor best score f and the predecessor index parent (-1 = chain
// start); returns argmax f.  Scoring matches the python golden model:
// gain = min(dq, dr, k) - 0.01*k*|dr-dq| - 0.5*log2(|dr-dq|+1).
int64_t fg_chain_anchors(const int64_t* qs, const int64_t* rs, int64_t n,
                         int32_t k, int32_t lookback, int64_t max_gap,
                         double* f, int64_t* parent) {
  if (n <= 0) return -1;
  const double kf = (double)k;
  for (int64_t i = 0; i < n; i++) {
    f[i] = kf;
    parent[i] = -1;
    int64_t j0 = i - lookback;
    if (j0 < 0) j0 = 0;
    double best = kf;
    int64_t bj = -1;
    for (int64_t j = j0; j < i; j++) {
      int64_t dq = qs[i] - qs[j];
      int64_t dr = rs[i] - rs[j];
      if (dq <= 0 || dr <= 0 || dq > max_gap || dr > max_gap) continue;
      int64_t gap = dr > dq ? dr - dq : dq - dr;
      int64_t mn = dq < dr ? dq : dr;
      double gain = (double)(mn < k ? mn : k)
          - 0.01 * kf * (double)gap - 0.5 * std::log2((double)gap + 1.0);
      double cand = f[j] + gain;
      if (cand > best) { best = cand; bj = j; }
    }
    f[i] = best;
    parent[i] = bj;
  }
  int64_t end = 0;
  for (int64_t i = 1; i < n; i++)
    if (f[i] > f[end]) end = i;
  return end;
}

}  // extern "C"
