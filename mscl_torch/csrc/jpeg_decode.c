/* Baseline JPEG decoding for the host data path's frame reader,
 * mscl_torch/utils/jpeg.py, giving what OpenCV's IMREAD_COLOR_RGB and
 * IMREAD_REDUCED_COLOR_2 give with libjpeg-turbo underneath, bit for bit.
 *
 * What it takes: SOF0 and SOF1 (sequential Huffman), 8-bit samples, 1 or 3
 * components (grey, or YCbCr), any sampling factors whose ratios the
 * upsamplers below handle, one scan holding every component, DQT tables of
 * 8 and 16 bits, DRI with RSTn markers; APPn and COM are skipped. What it
 * refuses, with a reason: progressive, arithmetic, lossless, hierarchical
 * and 12-bit files, 2 and 4 components, RGB-coded (Adobe transform 0 or
 * component ids R, G, B) files, a scan that lacks a component, truncated
 * or corrupt entropy data, and an EXIF orientation other than 1 (OpenCV
 * rotates by it).
 *
 * The arithmetic is libjpeg-turbo's, step by step:
 * - the IDCT: jidctint.c jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2) for
 *   8x8 output, jidctred.c jpeg_idct_4x4 for 4x4 output; the output goes
 *   through the range-limit table, whose index wraps at 1024 (RANGE_MASK);
 * - the scaled decode (reduce 2): every component starts at a 4x4 IDCT, and
 *   jdmaster.c doubles a component's size while its sampling ratio to the
 *   largest divides evenly (so 4:2:0 chroma takes the 8x8 IDCT and is not
 *   upsampled); the output is ceil(w / 2) x ceil(h / 2);
 * - upsampling (jdsample.c): fancy h2v1, h1v2 and h2v2 (triangle filters,
 *   the edges replicated, as jdmainct.c's context rows are), else plain
 *   replication; h2v1 and h2v2 are fancy only where the component's
 *   downsampled width exceeds 2;
 * - colour: jdcolor.c's ycc_rgb tables (SCALEBITS 16); grey is repeated
 *   into 3 channels.
 *
 * The whole image is decoded from a buffer in one call, with no callback
 * into Python, so ctypes releases the GIL around it. Built with the host C
 * compiler into build/ (ops/cuda_build.py load_host); a plain C interface.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MAXC 4

static const int natural_order[64 + 16] = {
  0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
  35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
  58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
  63, 63, 63, 63, 63, 63, 63, 63, /* a corrupt run past 63 lands here */
  63, 63, 63, 63, 63, 63, 63, 63
};

#define LOOKAHEAD 9

typedef struct {
  uint16_t look[1 << LOOKAHEAD];  /* (length << 8) | symbol; 0: longer */
  int32_t maxcode[18];            /* largest code of each length, or -1 */
  int32_t valoffset[17];          /* symbol index minus the first code */
  uint8_t vals[256];
  int present;
} huff_t;

typedef struct {
  int id, h, v, tq, td, ta;
  int ss;               /* DCT scaled size: 8, or 4 at reduce 2 */
  int wib, hib;         /* blocks holding image samples */
  int bw, bh;           /* blocks decoded across and down */
  int dw, dh;           /* downsampled width and height, in samples */
  int stride;
  uint8_t *plane;
  int pred;
  int16_t q[64];        /* natural order, as libjpeg's ISLOW_MULT_TYPE */
} comp_t;

typedef struct {
  const uint8_t *buf;
  size_t len, pos;
  int width, height, nc, hmax, vmax;
  int jfif, adobe, adobe_transform, orientation;
  int restart_interval;
  int qt_present[4];
  uint16_t qt[4][64];   /* zigzag order, as stored */
  huff_t dc[4], ac[4];
  comp_t comp[MAXC];
  int ns, scan[MAXC];
  int reduce, out_w, out_h, min_ss;
  char *err;
  size_t errcap;
} dec_t;

static int fail(dec_t *d, const char *msg) {
  if (d->err && d->errcap) snprintf(d->err, d->errcap, "%s", msg);
  return -1;
}

static int u16(const uint8_t *p) { return (p[0] << 8) | p[1]; }

/* ------------------------------------------------------------ headers */

static int build_huff(dec_t *d, huff_t *t, const uint8_t *counts,
                      const uint8_t *vals, int nvals) {
  int code = 0, k = 0, len, i;
  memset(t, 0, sizeof(*t));
  memcpy(t->vals, vals, (size_t)nvals);
  for (len = 1; len <= 16; len++) {
    t->valoffset[len] = k - code;
    if (counts[len - 1]) {
      /* no code may be all ones (jdhuff.c jpeg_make_d_derived_tbl) */
      if (code + counts[len - 1] >= (1 << len))
        return fail(d, "bad Huffman table");
      for (i = 0; i < counts[len - 1]; i++, k++, code++) {
        if (len <= LOOKAHEAD) {
          int shift = LOOKAHEAD - len, j;
          for (j = 0; j < (1 << shift); j++)
            t->look[(code << shift) | j] =
                (uint16_t)((len << 8) | vals[k]);
        }
      }
      t->maxcode[len] = code - 1;
    } else {
      t->maxcode[len] = -1;
    }
    code <<= 1;
  }
  t->maxcode[17] = 0x7FFFFFFF;
  t->present = 1;
  return 0;
}

static int parse_dht(dec_t *d, const uint8_t *p, int n) {
  while (n > 0) {
    int tc, th, nvals = 0, i;
    if (n < 17) return fail(d, "corrupt DHT segment");
    tc = p[0] >> 4;
    th = p[0] & 15;
    for (i = 0; i < 16; i++) nvals += p[1 + i];
    if (tc > 1 || th > 3 || nvals > 256 || n < 17 + nvals)
      return fail(d, "corrupt DHT segment");
    if (build_huff(d, tc ? &d->ac[th] : &d->dc[th], p + 1, p + 17, nvals))
      return -1;
    p += 17 + nvals;
    n -= 17 + nvals;
  }
  return 0;
}

static int parse_dqt(dec_t *d, const uint8_t *p, int n) {
  while (n > 0) {
    int pq = p[0] >> 4, tq = p[0] & 15, i;
    if (pq > 1 || tq > 3 || n < 1 + 64 * (pq + 1))
      return fail(d, "corrupt DQT segment");
    for (i = 0; i < 64; i++)
      d->qt[tq][i] = (uint16_t)(pq ? u16(p + 1 + 2 * i) : p[1 + i]);
    d->qt_present[tq] = 1;
    p += 1 + 64 * (pq + 1);
    n -= 1 + 64 * (pq + 1);
  }
  return 0;
}

static int parse_sof(dec_t *d, const uint8_t *p, int n) {
  int i;
  if (n < 6) return fail(d, "corrupt SOF segment");
  if (p[0] != 8)
    return fail(d, "only 8-bit samples are supported (this file has 12 or "
                   "another precision)");
  d->height = u16(p + 1);
  d->width = u16(p + 3);
  d->nc = p[5];
  if (d->width == 0 || d->height == 0)
    return fail(d, "image size missing (DNL is not supported)");
  if (d->nc == 4)
    return fail(d, "CMYK/YCCK (4-component) JPEG is not supported");
  if (d->nc != 1 && d->nc != 3)
    return fail(d, "only 1- and 3-component JPEG is supported");
  if (n < 6 + 3 * d->nc) return fail(d, "corrupt SOF segment");
  d->hmax = d->vmax = 1;
  for (i = 0; i < d->nc; i++) {
    comp_t *c = &d->comp[i];
    c->id = p[6 + 3 * i];
    c->h = p[7 + 3 * i] >> 4;
    c->v = p[7 + 3 * i] & 15;
    c->tq = p[8 + 3 * i];
    if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3)
      return fail(d, "bad sampling factors or table in SOF");
    if (c->h > d->hmax) d->hmax = c->h;
    if (c->v > d->vmax) d->vmax = c->v;
  }
  return 0;
}

static int parse_sos(dec_t *d, const uint8_t *p, int n) {
  int i, j;
  if (n < 1) return fail(d, "corrupt SOS segment");
  d->ns = p[0];
  if (d->ns != d->nc)
    return fail(d, "multi-scan sequential JPEG is not supported (a scan "
                   "lacks a component)");
  if (n < 4 + 2 * d->ns) return fail(d, "corrupt SOS segment");
  for (i = 0; i < d->ns; i++) {
    int id = p[1 + 2 * i], found = -1;
    for (j = 0; j < d->nc; j++)
      if (d->comp[j].id == id) found = j;
    if (found < 0) return fail(d, "SOS names an unknown component");
    for (j = 0; j < i; j++)
      if (d->scan[j] == found) return fail(d, "SOS repeats a component");
    d->scan[i] = found;
    d->comp[found].td = p[2 + 2 * i] >> 4;
    d->comp[found].ta = p[2 + 2 * i] & 15;
    if (d->comp[found].td > 3 || d->comp[found].ta > 3)
      return fail(d, "bad Huffman table index in SOS");
  }
  p += 1 + 2 * d->ns;
  if (p[0] != 0 || p[1] != 63 || p[2] != 0)
    return fail(d, "not a sequential scan (spectral selection or "
                   "successive approximation)");
  return 0;
}

/* The Orientation tag (0x0112) of an APP1 Exif segment's IFD0, or 1. */
static int exif_orientation(const uint8_t *p, int n) {
  const uint8_t *t;
  int le, nt, i;
  uint32_t off;
  if (n < 14 || memcmp(p, "Exif\0\0", 6)) return 1;
  t = p + 6;
  n -= 6;
  if (!memcmp(t, "II", 2)) le = 1;
  else if (!memcmp(t, "MM", 2)) le = 0;
  else return 1;
#define RD16(q) (le ? ((q)[0] | ((q)[1] << 8)) : (((q)[0] << 8) | (q)[1]))
#define RD32(q) (le ? ((uint32_t)(q)[0] | ((uint32_t)(q)[1] << 8) | \
                       ((uint32_t)(q)[2] << 16) | ((uint32_t)(q)[3] << 24)) \
                    : (((uint32_t)(q)[0] << 24) | ((uint32_t)(q)[1] << 16) | \
                       ((uint32_t)(q)[2] << 8) | (uint32_t)(q)[3]))
  off = RD32(t + 4);
  if (off + 2 > (uint32_t)n) return 1;
  nt = RD16(t + off);
  for (i = 0; i < nt; i++) {
    const uint8_t *e = t + off + 2 + 12 * i;
    if ((size_t)(e - t) + 12 > (size_t)n) break;
    if (RD16(e) == 0x0112) return RD16(e + 8);
  }
#undef RD16
#undef RD32
  return 1;
}

/* The markers up to and including the first SOS; d->pos is then the first
 * byte of entropy-coded data. */
static int parse_headers(dec_t *d) {
  int seen_sof = 0;
  if (d->len < 4 || d->buf[0] != 0xFF || d->buf[1] != 0xD8)
    return fail(d, "not a JPEG file (no SOI marker)");
  d->pos = 2;
  d->orientation = 1;
  for (;;) {
    int m, n;
    const uint8_t *p;
    while (d->pos < d->len && d->buf[d->pos] != 0xFF) d->pos++;
    while (d->pos < d->len && d->buf[d->pos] == 0xFF) d->pos++;
    if (d->pos >= d->len) return fail(d, "truncated file (no scan)");
    m = d->buf[d->pos++];
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (m == 0xD9) return fail(d, "no image data before EOI");
    if (d->pos + 2 > d->len) return fail(d, "truncated file (headers)");
    n = u16(d->buf + d->pos) - 2;
    if (n < 0 || d->pos + 2 + (size_t)n > d->len)
      return fail(d, "truncated file (headers)");
    p = d->buf + d->pos + 2;
    d->pos += 2 + (size_t)n;
    switch (m) {
      case 0xC0: case 0xC1:
        if (seen_sof) return fail(d, "more than one SOF marker");
        if (parse_sof(d, p, n)) return -1;
        seen_sof = 1;
        break;
      case 0xC2: case 0xC6: case 0xCA: case 0xCE:
        return fail(d, "progressive JPEG is not supported");
      case 0xC3: case 0xC7: case 0xCB: case 0xCF:
        return fail(d, "lossless JPEG is not supported");
      case 0xC5:
        return fail(d, "hierarchical JPEG is not supported");
      case 0xC9: case 0xCD: case 0xCC:
        return fail(d, "arithmetic-coded JPEG is not supported");
      case 0xC4:
        if (parse_dht(d, p, n)) return -1;
        break;
      case 0xDB:
        if (parse_dqt(d, p, n)) return -1;
        break;
      case 0xDD:
        if (n < 2) return fail(d, "corrupt DRI segment");
        d->restart_interval = u16(p);
        break;
      case 0xE0:
        if (n >= 14 && !memcmp(p, "JFIF\0", 5)) d->jfif = 1;
        break;
      case 0xE1:
        if (d->orientation == 1) d->orientation = exif_orientation(p, n);
        break;
      case 0xEE:
        if (n >= 12 && !memcmp(p, "Adobe", 5)) {
          d->adobe = 1;
          d->adobe_transform = p[11];
        }
        break;
      case 0xDA:
        if (!seen_sof) return fail(d, "SOS before SOF");
        return parse_sos(d, p, n);
      default:
        break;          /* APPn, COM and the rest: skipped */
    }
  }
}

/* What libjpeg-turbo's jdmaster.c and jdapimin.c decide from the headers:
 * the colour space, each component's DCT scaled size and downsampled
 * size, the output size; and the refusals. */
static int setup(dec_t *d) {
  int i, mcux, mcuy;
  if (d->orientation >= 2 && d->orientation <= 8) {
    char msg[96];
    snprintf(msg, sizeof(msg), "EXIF orientation %d is not supported "
             "(OpenCV would rotate the image)", d->orientation);
    return fail(d, msg);
  }
  if (d->nc == 3) {
    int rgb;
    if (d->jfif) rgb = 0;
    else if (d->adobe) rgb = d->adobe_transform == 0;
    else rgb = d->comp[0].id == 82 && d->comp[1].id == 71 &&
               d->comp[2].id == 66;
    if (rgb) return fail(d, "RGB-coded (Adobe RGB) JPEG is not supported");
  }
  d->min_ss = d->reduce == 2 ? 4 : 8;
  d->out_w = (int)(((int64_t)d->width * d->min_ss + 7) / 8);
  d->out_h = (int)(((int64_t)d->height * d->min_ss + 7) / 8);
  mcux = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
  mcuy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
  for (i = 0; i < d->nc; i++) {
    comp_t *c = &d->comp[i];
    int ss = d->min_ss, k;
    while (ss < 8 && (d->hmax * d->min_ss) % (c->h * ss * 2) == 0 &&
           (d->vmax * d->min_ss) % (c->v * ss * 2) == 0)
      ss *= 2;
    c->ss = ss;
    if (!d->qt_present[c->tq]) return fail(d, "missing quantization table");
    if (!d->dc[c->td].present || !d->ac[c->ta].present)
      return fail(d, "missing Huffman table");
    for (k = 0; k < 64; k++)
      c->q[natural_order[k]] = (int16_t)d->qt[c->tq][k];
    c->wib = (int)(((int64_t)d->width * c->h + 8 * d->hmax - 1) /
                   (8 * d->hmax));
    c->hib = (int)(((int64_t)d->height * c->v + 8 * d->vmax - 1) /
                   (8 * d->vmax));
    c->bw = d->ns > 1 ? mcux * c->h : c->wib;
    c->bh = d->ns > 1 ? mcuy * c->v : c->hib;
    c->dw = (int)(((int64_t)d->width * c->h * ss + 8 * d->hmax - 1) /
                  (8 * d->hmax));
    c->dh = (int)(((int64_t)d->height * c->v * ss + 8 * d->vmax - 1) /
                  (8 * d->vmax));
    c->stride = c->bw * ss;
    /* the upsampler needs whole ratios (JERR_FRACT_SAMPLE_NOTIMPL) */
    {
      int hin = c->h * ss / d->min_ss, vin = c->v * ss / d->min_ss;
      if (hin == 0 || vin == 0 || d->hmax % hin || d->vmax % vin)
        return fail(d, "fractional sampling ratio is not supported");
    }
  }
  return 0;
}

/* --------------------------------------------------------- entropy data */

typedef struct {
  const uint8_t *p, *end;
  uint64_t acc;         /* MSB-aligned */
  int nbits;
  int pad;              /* zero bits past a marker, at the low end */
  int truncated;
} bits_t;

static void fill(bits_t *b) {
  while (b->nbits <= 56) {
    int c = 0;
    if (b->p < b->end && b->p[0] != 0xFF) {
      c = *b->p++;
    } else if (b->p + 1 < b->end && b->p[0] == 0xFF && b->p[1] == 0x00) {
      c = 0xFF;
      b->p += 2;
    } else {
      /* a marker, or the end of the buffer: zeros from here on */
      b->pad += 8;
    }
    b->acc |= (uint64_t)c << (56 - b->nbits);
    b->nbits += 8;
  }
}

static inline void consume(bits_t *b, int n) {
  b->acc <<= n;
  b->nbits -= n;
  if (b->nbits < b->pad) {
    b->truncated = 1;
    b->pad = b->nbits;
  }
}

static inline int getbits(bits_t *b, int n) {
  int v;
  if (n == 0) return 0;
  if (b->nbits < n) fill(b);
  v = (int)(b->acc >> (64 - n));
  consume(b, n);
  return v;
}

static inline int decode(bits_t *b, const huff_t *t) {
  int e, len;
  if (b->nbits < 16) fill(b);
  e = t->look[b->acc >> (64 - LOOKAHEAD)];
  if (e) {
    consume(b, e >> 8);
    return e & 0xFF;
  }
  for (len = LOOKAHEAD + 1; len <= 16; len++) {
    int code = (int)(b->acc >> (64 - len));
    if (code <= t->maxcode[len]) {
      consume(b, len);
      return t->vals[(t->valoffset[len] + code) & 0xFF];
    }
  }
  return -1;
}

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (int)(((unsigned)-1) << s) + 1 : v;
}

/* ------------------------------------------------------------------ IDCT */

typedef int64_t JLONG;
#define CONST_BITS 13
#define PASS1_BITS 2
#define ONE ((JLONG)1)
#define LEFT_SHIFT(a, b) ((JLONG)((uint64_t)(a) << (b)))
#define DESCALE(x, n) (((x) + (ONE << ((n) - 1))) >> (n))
#define DEQUANTIZE(coef, q) ((int)(coef) * (int)(q))

/* IDCT_range_limit[x & RANGE_MASK]: the low 10 bits as a signed value,
 * plus 128, clamped to 0..255 */
static inline uint8_t range_limit(JLONG x) {
  int v = (int)(x & 1023);
  if (v >= 512) v -= 1024;
  v += 128;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

static void idct_islow(const int16_t *in, const int16_t *q, uint8_t *out,
                       int stride) {
  JLONG tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
  JLONG z1, z2, z3, z4, z5;
  int ws[64], *w, ctr;
  for (ctr = 0; ctr < 8; ctr++) {
    const int16_t *ip = in + ctr;
    const int16_t *qp = q + ctr;
    w = ws + ctr;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dc = (int)LEFT_SHIFT(DEQUANTIZE(ip[0], qp[0]), PASS1_BITS);
      w[0] = w[8] = w[16] = w[24] = w[32] = w[40] = w[48] = w[56] = dc;
      continue;
    }
    z2 = DEQUANTIZE(ip[16], qp[16]);
    z3 = DEQUANTIZE(ip[48], qp[48]);
    z1 = (z2 + z3) * 4433;
    tmp2 = z1 + z3 * -15137;
    tmp3 = z1 + z2 * 6270;
    z2 = DEQUANTIZE(ip[0], qp[0]);
    z3 = DEQUANTIZE(ip[32], qp[32]);
    tmp0 = LEFT_SHIFT(z2 + z3, CONST_BITS);
    tmp1 = LEFT_SHIFT(z2 - z3, CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = DEQUANTIZE(ip[56], qp[56]);
    tmp1 = DEQUANTIZE(ip[40], qp[40]);
    tmp2 = DEQUANTIZE(ip[24], qp[24]);
    tmp3 = DEQUANTIZE(ip[8], qp[8]);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
    w[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
    w[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
    w[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
    w[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
    w[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
    w[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
    w[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
  }
  for (ctr = 0; ctr < 8; ctr++) {
    uint8_t *o = out + ctr * stride;
    w = ws + 8 * ctr;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = range_limit(DESCALE((JLONG)w[0], PASS1_BITS + 3));
      memset(o, v, 8);
      continue;
    }
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * 4433;
    tmp2 = z1 + z3 * -15137;
    tmp3 = z1 + z2 * 6270;
    tmp0 = LEFT_SHIFT((JLONG)w[0] + (JLONG)w[4], CONST_BITS);
    tmp1 = LEFT_SHIFT((JLONG)w[0] - (JLONG)w[4], CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 *= -16069;
    z4 *= -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = range_limit(DESCALE(tmp10 + tmp3, CONST_BITS + PASS1_BITS + 3));
    o[7] = range_limit(DESCALE(tmp10 - tmp3, CONST_BITS + PASS1_BITS + 3));
    o[1] = range_limit(DESCALE(tmp11 + tmp2, CONST_BITS + PASS1_BITS + 3));
    o[6] = range_limit(DESCALE(tmp11 - tmp2, CONST_BITS + PASS1_BITS + 3));
    o[2] = range_limit(DESCALE(tmp12 + tmp1, CONST_BITS + PASS1_BITS + 3));
    o[5] = range_limit(DESCALE(tmp12 - tmp1, CONST_BITS + PASS1_BITS + 3));
    o[3] = range_limit(DESCALE(tmp13 + tmp0, CONST_BITS + PASS1_BITS + 3));
    o[4] = range_limit(DESCALE(tmp13 - tmp0, CONST_BITS + PASS1_BITS + 3));
  }
}

/* jidctred.c jpeg_idct_4x4 (the libjpeg 6b reduced IDCT) */
static void idct_4x4(const int16_t *in, const int16_t *q, uint8_t *out,
                     int stride) {
  JLONG tmp0, tmp2, tmp10, tmp12, z1, z2, z3, z4;
  int ws[32], *w, ctr;
  for (ctr = 0; ctr < 8; ctr++) {
    const int16_t *ip = in + ctr;
    const int16_t *qp = q + ctr;
    w = ws + ctr;
    if (ctr == 4) continue;     /* pass 2 does not read column 4 */
    if (!ip[8] && !ip[16] && !ip[24] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = (int)LEFT_SHIFT(DEQUANTIZE(ip[0], qp[0]), PASS1_BITS);
      w[0] = w[8] = w[16] = w[24] = dc;
      continue;
    }
    tmp0 = DEQUANTIZE(ip[0], qp[0]);
    tmp0 = LEFT_SHIFT(tmp0, CONST_BITS + 1);
    z2 = DEQUANTIZE(ip[16], qp[16]);
    z3 = DEQUANTIZE(ip[48], qp[48]);
    tmp2 = z2 * 15137 + z3 * -6270;
    tmp10 = tmp0 + tmp2;
    tmp12 = tmp0 - tmp2;
    z1 = DEQUANTIZE(ip[56], qp[56]);
    z2 = DEQUANTIZE(ip[40], qp[40]);
    z3 = DEQUANTIZE(ip[24], qp[24]);
    z4 = DEQUANTIZE(ip[8], qp[8]);
    tmp0 = z1 * -1730 + z2 * 11893 + z3 * -17799 + z4 * 8697;
    tmp2 = z1 * -4176 + z2 * -4926 + z3 * 7373 + z4 * 20995;
    w[0] = (int)DESCALE(tmp10 + tmp2, CONST_BITS - PASS1_BITS + 1);
    w[24] = (int)DESCALE(tmp10 - tmp2, CONST_BITS - PASS1_BITS + 1);
    w[8] = (int)DESCALE(tmp12 + tmp0, CONST_BITS - PASS1_BITS + 1);
    w[16] = (int)DESCALE(tmp12 - tmp0, CONST_BITS - PASS1_BITS + 1);
  }
  for (ctr = 0; ctr < 4; ctr++) {
    uint8_t *o = out + ctr * stride;
    w = ws + 8 * ctr;
    if (!w[1] && !w[2] && !w[3] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = range_limit(DESCALE((JLONG)w[0], PASS1_BITS + 3));
      o[0] = o[1] = o[2] = o[3] = v;
      continue;
    }
    tmp0 = LEFT_SHIFT((JLONG)w[0], CONST_BITS + 1);
    tmp2 = (JLONG)w[2] * 15137 + (JLONG)w[6] * -6270;
    tmp10 = tmp0 + tmp2;
    tmp12 = tmp0 - tmp2;
    z1 = w[7];
    z2 = w[5];
    z3 = w[3];
    z4 = w[1];
    tmp0 = z1 * -1730 + z2 * 11893 + z3 * -17799 + z4 * 8697;
    tmp2 = z1 * -4176 + z2 * -4926 + z3 * 7373 + z4 * 20995;
    o[0] = range_limit(DESCALE(tmp10 + tmp2,
                               CONST_BITS + PASS1_BITS + 3 + 1));
    o[3] = range_limit(DESCALE(tmp10 - tmp2,
                               CONST_BITS + PASS1_BITS + 3 + 1));
    o[1] = range_limit(DESCALE(tmp12 + tmp0,
                               CONST_BITS + PASS1_BITS + 3 + 1));
    o[2] = range_limit(DESCALE(tmp12 - tmp0,
                               CONST_BITS + PASS1_BITS + 3 + 1));
  }
}

/* ------------------------------------------------------------ the scan */

static int decode_block(bits_t *b, dec_t *d, comp_t *c, int16_t *blk) {
  const huff_t *dc = &d->dc[c->td], *ac = &d->ac[c->ta];
  int s, k, r;
  memset(blk, 0, 64 * sizeof(int16_t));
  s = decode(b, dc);
  if (s < 0 || s > 15) return fail(d, "corrupt JPEG data (bad Huffman code)");
  if (s) s = extend(getbits(b, s), s);
  c->pred += s;
  blk[0] = (int16_t)c->pred;
  for (k = 1; k < 64; k++) {
    int rs = decode(b, ac);
    if (rs < 0) return fail(d, "corrupt JPEG data (bad Huffman code)");
    r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[natural_order[k]] = (int16_t)extend(getbits(b, s), s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  if (b->truncated) return fail(d, "truncated JPEG data");
  return 0;
}

static void put_block(comp_t *c, const int16_t *blk, int bx, int by) {
  uint8_t *o = c->plane + (size_t)by * c->ss * c->stride + (size_t)bx * c->ss;
  if (c->ss == 8) idct_islow(blk, c->q, o, c->stride);
  else idct_4x4(blk, c->q, o, c->stride);
}

/* The marker a restart interval ends with: RST(n % 8). */
static int restart(dec_t *d, bits_t *b, int n) {
  const uint8_t *p = b->p;
  while (p < b->end && !(p[0] == 0xFF && p + 1 < b->end && p[1] != 0x00 &&
                         p[1] != 0xFF))
    p++;
  if (p + 1 >= b->end) return fail(d, "truncated JPEG data (no RST marker)");
  if (p[1] != 0xD0 + (n & 7)) return fail(d, "corrupt JPEG data (RST marker "
                                             "out of sequence)");
  b->p = p + 2;
  b->acc = 0;
  b->nbits = b->pad = 0;
  return 0;
}

static int decode_scan(dec_t *d) {
  bits_t b;
  int16_t blk[64];
  int i, mx, my, mcux, mcuy, left, nrst = 0;
  memset(&b, 0, sizeof(b));
  b.p = d->buf + d->pos;
  b.end = d->buf + d->len;
  if (d->ns == 1) {
    mcux = d->comp[d->scan[0]].wib;
    mcuy = d->comp[d->scan[0]].hib;
  } else {
    mcux = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
    mcuy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
  }
  left = d->restart_interval;
  for (my = 0; my < mcuy; my++) {
    for (mx = 0; mx < mcux; mx++) {
      if (d->restart_interval && left == 0) {
        if (restart(d, &b, nrst++)) return -1;
        for (i = 0; i < d->nc; i++) d->comp[i].pred = 0;
        left = d->restart_interval;
      }
      for (i = 0; i < d->ns; i++) {
        comp_t *c = &d->comp[d->scan[i]];
        int bx, by;
        if (d->ns == 1) {
          if (decode_block(&b, d, c, blk)) return -1;
          put_block(c, blk, mx, my);
          continue;
        }
        for (by = 0; by < c->v; by++)
          for (bx = 0; bx < c->h; bx++) {
            if (decode_block(&b, d, c, blk)) return -1;
            put_block(c, blk, mx * c->h + bx, my * c->v + by);
          }
      }
      left--;
    }
  }
  return 0;
}

/* --------------------------------------------------- upsample, colour */

/* Output row y of component c, upsampled to at least out_w samples, into
 * tmp (or a row of the plane itself). */
static const uint8_t *upsample_row(const dec_t *d, const comp_t *c, int y,
                                   uint8_t *tmp) {
  int hin = c->h * c->ss / d->min_ss, vin = c->v * c->ss / d->min_ss;
  int he = d->hmax / hin, ve = d->vmax / vin;
  int dw = c->dw, x;
  const uint8_t *row;
  if (he == 1 && ve == 1) return c->plane + (size_t)y * c->stride;
  if (he == 2 && ve == 1 && dw > 2) {             /* h2v1 fancy */
    row = c->plane + (size_t)y * c->stride;
    tmp[0] = row[0];
    tmp[1] = (uint8_t)((row[0] * 3 + row[1] + 2) >> 2);
    for (x = 1; x < dw - 1; x++) {
      int v = row[x] * 3;
      tmp[2 * x] = (uint8_t)((v + row[x - 1] + 1) >> 2);
      tmp[2 * x + 1] = (uint8_t)((v + row[x + 1] + 2) >> 2);
    }
    tmp[2 * dw - 2] = (uint8_t)((row[dw - 1] * 3 + row[dw - 2] + 1) >> 2);
    tmp[2 * dw - 1] = row[dw - 1];
    return tmp;
  }
  if (he == 1 && ve == 2) {                       /* h1v2 fancy */
    int near = y >> 1, far = (y & 1) ? near + 1 : near - 1;
    int bias = (y & 1) ? 2 : 1;
    const uint8_t *r1;
    if (far < 0) far = 0;
    if (far > c->dh - 1) far = c->dh - 1;
    row = c->plane + (size_t)near * c->stride;
    r1 = c->plane + (size_t)far * c->stride;
    for (x = 0; x < dw; x++)
      tmp[x] = (uint8_t)((row[x] * 3 + r1[x] + bias) >> 2);
    return tmp;
  }
  if (he == 2 && ve == 2 && dw > 2) {             /* h2v2 fancy */
    int near = y >> 1, far = (y & 1) ? near + 1 : near - 1;
    int this_, last, next;
    const uint8_t *r1;
    if (far < 0) far = 0;
    if (far > c->dh - 1) far = c->dh - 1;
    row = c->plane + (size_t)near * c->stride;
    r1 = c->plane + (size_t)far * c->stride;
    this_ = row[0] * 3 + r1[0];
    next = row[1] * 3 + r1[1];
    tmp[0] = (uint8_t)((this_ * 4 + 8) >> 4);
    tmp[1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
    last = this_;
    this_ = next;
    for (x = 1; x < dw - 1; x++) {
      next = row[x + 1] * 3 + r1[x + 1];
      tmp[2 * x] = (uint8_t)((this_ * 3 + last + 8) >> 4);
      tmp[2 * x + 1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
      last = this_;
      this_ = next;
    }
    tmp[2 * dw - 2] = (uint8_t)((this_ * 3 + last + 8) >> 4);
    tmp[2 * dw - 1] = (uint8_t)((this_ * 4 + 7) >> 4);
    return tmp;
  }
  /* plain replication: h2v1, h2v2 at widths of 1 or 2, and every other
   * whole ratio (int_upsample) */
  row = c->plane + (size_t)(y / ve) * c->stride;
  for (x = 0; x < d->out_w; x++) tmp[x] = row[x / he];
  return tmp;
}

#define SCALEBITS 16
#define ONE_HALF ((JLONG)1 << (SCALEBITS - 1))
#define FIX(x) ((JLONG)((x) * (1L << SCALEBITS) + 0.5))

static void write_rgb(dec_t *d, uint8_t *out) {
  int cr_r[256], cb_b[256], y, x, i;
  JLONG cr_g[256], cb_g[256];
  uint8_t clamp[256 * 3], *rl = clamp + 256;
  uint8_t *tmp = (uint8_t *)malloc((size_t)3 * (d->out_w + 16));
  for (i = 0; i < 256; i++) {
    clamp[i] = 0;
    clamp[256 + i] = (uint8_t)i;
    clamp[512 + i] = 255;
  }
  for (i = 0, x = -128; i < 256; i++, x++) {
    cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
    cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
    cr_g[i] = (-FIX(0.71414)) * x;
    cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
  }
  for (y = 0; y < d->out_h; y++) {
    uint8_t *o = out + (size_t)y * d->out_w * 3;
    if (d->nc == 1) {
      const uint8_t *g = upsample_row(d, &d->comp[0], y, tmp);
      for (x = 0; x < d->out_w; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] =
                                         g[x];
      continue;
    }
    {
      const uint8_t *yy = upsample_row(d, &d->comp[0], y, tmp);
      const uint8_t *cb = upsample_row(d, &d->comp[1], y,
                                       tmp + d->out_w + 16);
      const uint8_t *cr = upsample_row(d, &d->comp[2], y,
                                       tmp + 2 * (d->out_w + 16));
      for (x = 0; x < d->out_w; x++) {
        int l = yy[x], b = cb[x], r = cr[x];
        o[3 * x] = rl[l + cr_r[r]];
        o[3 * x + 1] = rl[l + (int)((cb_g[b] + cr_g[r]) >> SCALEBITS)];
        o[3 * x + 2] = rl[l + cb_b[b]];
      }
    }
  }
  free(tmp);
}

/* ------------------------------------------------------------ interface */

static int prepare(dec_t *d, const uint8_t *buf, int64_t len, int reduce,
                   char *err, int64_t errcap) {
  memset(d, 0, sizeof(*d));
  d->buf = buf;
  d->len = (size_t)len;
  d->err = err;
  d->errcap = (size_t)errcap;
  if (reduce != 1 && reduce != 2) return fail(d, "reduce must be 1 or 2");
  d->reduce = reduce;
  if (parse_headers(d)) return -1;
  return setup(d);
}

/* The decoded size: dims[0] = height, dims[1] = width at this reduce.
 * Returns 0, or -1 with the reason in err. */
int jpeg_dims(const uint8_t *buf, int64_t len, int reduce, int32_t *dims,
              char *err, int64_t errcap) {
  dec_t d;
  if (prepare(&d, buf, len, reduce, err, errcap)) return -1;
  dims[0] = d.out_h;
  dims[1] = d.out_w;
  return 0;
}

/* Decode into out, an (h, w, 3) RGB uint8 array of jpeg_dims' size.
 * Returns 0, or -1 with the reason in err. */
int jpeg_decode(const uint8_t *buf, int64_t len, int reduce, uint8_t *out,
                int32_t h, int32_t w, char *err, int64_t errcap) {
  dec_t d;
  int i, rc = 0;
  if (prepare(&d, buf, len, reduce, err, errcap)) return -1;
  if (d.out_h != h || d.out_w != w)
    return fail(&d, "output array does not have the decoded size");
  for (i = 0; i < d.nc; i++) {
    comp_t *c = &d.comp[i];
    c->plane = (uint8_t *)malloc((size_t)c->stride * c->bh * c->ss + 8);
    if (!c->plane) rc = fail(&d, "out of memory");
  }
  if (!rc) rc = decode_scan(&d);
  if (!rc) write_rgb(&d, out);
  for (i = 0; i < d.nc; i++) free(d.comp[i].plane);
  return rc;
}
