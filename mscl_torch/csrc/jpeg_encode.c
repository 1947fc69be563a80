/* Baseline JPEG encoding for the port's tools (mscl_torch/utils/jpeg.py
 * encode_jpeg / imwrite), writing the bytes that OpenCV's
 * cv2.imencode('.jpg', img) writes with its default parameters on top of
 * libjpeg-turbo, byte for byte:
 *
 * - markers: SOI, the JFIF APP0 (version 1.01, no density unit, 1 x 1), one
 *   DQT a table, SOF0, one DHT a table (DC then AC, per component as the
 *   scan first needs it), SOS, the entropy data, EOI; no restart markers;
 * - quantisation tables: the standard ones (Annex K) scaled as
 *   jcparam.c jpeg_set_quality does (quality < 50: 5000 / q, else
 *   200 - 2q percent, rounded, clamped to 1..255 for baseline);
 * - colour: jccolor.c's rgb_ycc tables (SCALEBITS 16, Cb and Cr rounded
 *   with 0.5 - epsilon); one component for a grey image;
 * - 4:2:0 sampling: jcsample.c h2v2_downsample (the mean of 2 x 2 with the
 *   bias alternating 1, 2 along a row), after the right edge is replicated
 *   to whole blocks (expand_right_edge) and the last row to whole row
 *   groups; each component's last block row is replicated to whole
 *   blocks (jcprepct.c), and the blocks of an MCU that lie wholly outside
 *   the component are jccoefct.c's dummy blocks: AC zero, the DC of the
 *   block before it in the MCU;
 * - the forward DCT: jfdctint.c jpeg_fdct_islow (CONST_BITS 13, PASS1_BITS
 *   2), the output scaled up by 8;
 * - quantisation: jcdctmgr.c's reciprocal division by (q << 3), with the
 *   16-bit elements of libjpeg-turbo's SIMD build;
 * - entropy coding: the standard Huffman tables, not optimised, with 0xFF
 *   stuffing and the last byte padded with ones.
 *
 * The whole image is encoded into a caller's buffer in one call, so ctypes
 * releases the GIL around it. Built with the host C compiler into build/
 * (ops/cuda_build.py load_host); a plain C interface.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static const int natural_order[64] = {
  0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
  35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
  58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63
};

/* The standard tables (JPEG Annex K), in zigzag order; each DHT table as
 * its 16 code counts and then its symbols. */
static const unsigned char std_q_luma_zz[64] = {
    16, 11, 12, 14, 12, 10, 16, 14,
    13, 14, 18, 17, 16, 19, 24, 40,
    26, 24, 22, 22, 24, 49, 35, 37,
    29, 40, 58, 51, 61, 60, 57, 51,
    56, 55, 64, 72, 92, 78, 64, 68,
    87, 69, 55, 56, 80, 109, 81, 87,
    95, 98, 103, 104, 103, 62, 77, 113,
    121, 112, 100, 120, 92, 101, 103, 99,
};
static const unsigned char std_q_chroma_zz[64] = {
    17, 18, 18, 24, 21, 24, 47, 26,
    26, 47, 99, 66, 56, 66, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
};
static const unsigned char dht_dc_luma[28] = {
    0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07,
    0x08, 0x09, 0x0a, 0x0b,
};
static const unsigned char dht_ac_luma[178] = {
    0x00, 0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04, 0x04,
    0x00, 0x00, 0x01, 0x7d, 0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32,
    0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55,
    0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85,
    0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2,
    0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea,
    0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa,
};
static const unsigned char dht_dc_chroma[28] = {
    0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07,
    0x08, 0x09, 0x0a, 0x0b,
};
static const unsigned char dht_ac_chroma[178] = {
    0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05, 0x04, 0x04,
    0x00, 0x01, 0x02, 0x77, 0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81,
    0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
    0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17,
    0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54,
    0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9,
    0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9,
    0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa,
};

typedef struct {
  uint8_t *out;
  int64_t cap, len;
  uint32_t acc;     /* bits not yet written, right-aligned */
  int nacc;
  int overflow;
} writer_t;

static void put_byte(writer_t *w, int b) {
  if (w->len < w->cap) w->out[w->len] = (uint8_t)b;
  else w->overflow = 1;
  w->len++;
}

static void put_bytes(writer_t *w, const uint8_t *p, int n) {
  for (int i = 0; i < n; i++) put_byte(w, p[i]);
}

static void put_u16(writer_t *w, int v) {
  put_byte(w, (v >> 8) & 0xFF);
  put_byte(w, v & 0xFF);
}

static void put_bits(writer_t *w, uint32_t code, int size) {
  if (size == 0) return;
  w->acc = (w->acc << size) | (code & ((1u << size) - 1));
  w->nacc += size;
  while (w->nacc >= 8) {
    int b = (w->acc >> (w->nacc - 8)) & 0xFF;
    put_byte(w, b);
    if (b == 0xFF) put_byte(w, 0);
    w->nacc -= 8;
  }
  w->acc &= (1u << w->nacc) - 1;
}

typedef struct {
  uint16_t code[256];
  uint8_t size[256];
} ehuff_t;

/* jchuff.c jpeg_make_c_derived_tbl: canonical codes from the counts. */
static void derive(const unsigned char *bits_vals, ehuff_t *t) {
  int k = 0;
  uint32_t code = 0;
  memset(t, 0, sizeof(*t));
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits_vals[l - 1]; i++) {
      int v = bits_vals[16 + k++];
      t->code[v] = (uint16_t)code++;
      t->size[v] = (uint8_t)l;
    }
    code <<= 1;
  }
}

#define CONST_BITS 13
#define PASS1_BITS 2
#define DESCALE(x, n) (((x) + (1 << ((n) - 1))) >> (n))

/* jfdctint.c jpeg_fdct_islow, in place on level-shifted samples. */
static void fdct_islow(int32_t *data) {
  int32_t tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, tmp7;
  int32_t tmp10, tmp11, tmp12, tmp13, z1, z2, z3, z4, z5;
  int32_t *p = data;
  for (int r = 0; r < 8; r++, p += 8) {
    tmp0 = p[0] + p[7]; tmp7 = p[0] - p[7];
    tmp1 = p[1] + p[6]; tmp6 = p[1] - p[6];
    tmp2 = p[2] + p[5]; tmp5 = p[2] - p[5];
    tmp3 = p[3] + p[4]; tmp4 = p[3] - p[4];
    tmp10 = tmp0 + tmp3; tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2; tmp12 = tmp1 - tmp2;
    p[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
    p[4] = (tmp10 - tmp11) * (1 << PASS1_BITS);
    z1 = (tmp12 + tmp13) * 4433;
    p[2] = DESCALE(z1 + tmp13 * 6270, CONST_BITS - PASS1_BITS);
    p[6] = DESCALE(z1 + tmp12 * -15137, CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7; z2 = tmp5 + tmp6; z3 = tmp4 + tmp6; z4 = tmp5 + tmp7;
    z5 = (z3 + z4) * 9633;
    tmp4 *= 2446; tmp5 *= 16819; tmp6 *= 25172; tmp7 *= 12299;
    z1 *= -7373; z2 *= -20995; z3 *= -16069; z4 *= -3196;
    z3 += z5; z4 += z5;
    p[7] = DESCALE(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = DESCALE(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = DESCALE(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = DESCALE(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  p = data;
  for (int c = 0; c < 8; c++, p++) {
    tmp0 = p[0] + p[56]; tmp7 = p[0] - p[56];
    tmp1 = p[8] + p[48]; tmp6 = p[8] - p[48];
    tmp2 = p[16] + p[40]; tmp5 = p[16] - p[40];
    tmp3 = p[24] + p[32]; tmp4 = p[24] - p[32];
    tmp10 = tmp0 + tmp3; tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2; tmp12 = tmp1 - tmp2;
    p[0] = DESCALE(tmp10 + tmp11, PASS1_BITS);
    p[32] = DESCALE(tmp10 - tmp11, PASS1_BITS);
    z1 = (tmp12 + tmp13) * 4433;
    p[16] = DESCALE(z1 + tmp13 * 6270, CONST_BITS + PASS1_BITS);
    p[48] = DESCALE(z1 + tmp12 * -15137, CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7; z2 = tmp5 + tmp6; z3 = tmp4 + tmp6; z4 = tmp5 + tmp7;
    z5 = (z3 + z4) * 9633;
    tmp4 *= 2446; tmp5 *= 16819; tmp6 *= 25172; tmp7 *= 12299;
    z1 *= -7373; z2 *= -20995; z3 *= -16069; z4 *= -3196;
    z3 += z5; z4 += z5;
    p[56] = DESCALE(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = DESCALE(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = DESCALE(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = DESCALE(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

typedef struct {
  uint32_t recip[64], corr[64];
  int shift[64];
  uint8_t zz[64];   /* the table as DQT writes it, zigzag order */
} quant_t;

static int floor_log2(uint32_t v) {
  int b = -1;
  while (v) { b++; v >>= 1; }
  return b;
}

static void make_quant(const unsigned char *std_zz, int quality,
                       quant_t *q) {
  int scale;
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int k = 0; k < 64; k++) {
    long v = ((long)std_zz[k] * scale + 50L) / 100L;
    if (v <= 0) v = 1;
    if (v > 255) v = 255;
    q->zz[k] = (uint8_t)v;
    /* jcdctmgr.c compute_reciprocal for the divisor (q << 3), 16 bits */
    {
      uint32_t d = (uint32_t)v << 3;
      int r = 16 + floor_log2(d);
      uint32_t fq = (1u << r) / d, fr = (1u << r) % d, c = d / 2;
      int n = natural_order[k];
      if (fr == 0) { fq >>= 1; r--; }
      else if (fr <= d / 2) c++;
      else fq++;
      q->recip[n] = fq;
      q->corr[n] = c;
      q->shift[n] = r;
    }
  }
}

static void quantize(const int32_t *ws, const quant_t *q, int32_t *coef) {
  for (int i = 0; i < 64; i++) {
    int32_t t = ws[i];
    uint32_t a = (uint32_t)(t < 0 ? -t : t);
    int32_t v = (int32_t)((((a + q->corr[i]) & 0xFFFF) * q->recip[i])
                          >> q->shift[i]);
    coef[i] = t < 0 ? -v : v;
  }
}

/* One 8x8 block of a plane (row stride `stride`) -> quantised
 * coefficients, natural order. */
static void forward_block(const uint8_t *plane, int64_t stride, int64_t y,
                          int64_t x, const quant_t *q, int32_t *coef) {
  int32_t ws[64];
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++)
      ws[r * 8 + c] = (int32_t)plane[(y + r) * stride + x + c] - 128;
  fdct_islow(ws);
  quantize(ws, q, coef);
}

static void encode_block(writer_t *w, const int32_t *coef, int32_t *last_dc,
                         const ehuff_t *dc, const ehuff_t *ac) {
  int32_t temp = coef[0] - *last_dc, temp2 = temp;
  int nbits = 0, run = 0;
  *last_dc = coef[0];
  if (temp < 0) { temp = -temp; temp2--; }
  while (temp) { nbits++; temp >>= 1; }
  put_bits(w, dc->code[nbits], dc->size[nbits]);
  if (nbits) put_bits(w, (uint32_t)temp2, nbits);
  for (int k = 1; k < 64; k++) {
    temp = coef[natural_order[k]];
    if (temp == 0) { run++; continue; }
    while (run > 15) {
      put_bits(w, ac->code[0xF0], ac->size[0xF0]);
      run -= 16;
    }
    temp2 = temp;
    if (temp < 0) { temp = -temp; temp2--; }
    nbits = 1;
    while ((temp >>= 1)) nbits++;
    put_bits(w, ac->code[(run << 4) + nbits], ac->size[(run << 4) + nbits]);
    put_bits(w, (uint32_t)temp2, nbits);
    run = 0;
  }
  if (run > 0) put_bits(w, ac->code[0], ac->size[0]);
}

/* A plane of w x h samples, edge-replicated to pw x ph. */
static void pad_plane(uint8_t *p, int64_t w, int64_t h, int64_t pw,
                      int64_t ph) {
  for (int64_t y = 0; y < h; y++)
    for (int64_t x = w; x < pw; x++) p[y * pw + x] = p[y * pw + w - 1];
  for (int64_t y = h; y < ph; y++)
    memcpy(p + y * pw, p + (h - 1) * pw, (size_t)pw);
}

static void put_dht(writer_t *w, int id, const unsigned char *bits_vals,
                    int n) {
  put_u16(w, 0xFFC4);
  put_u16(w, 2 + 1 + n);
  put_byte(w, id);
  put_bytes(w, bits_vals, n);
}

static void put_dqt(writer_t *w, int id, const quant_t *q) {
  put_u16(w, 0xFFDB);
  put_u16(w, 67);
  put_byte(w, id);
  put_bytes(w, q->zz, 64);
}

static int64_t div_up(int64_t a, int64_t b) { return (a + b - 1) / b; }

/* img: h x w x channels uint8 (channels 1, grey, or 3, RGB). Writes the
 * file into out (cap bytes) and its length into *out_len. Returns 0; 1 if
 * cap was too small (*out_len is then the length needed), 2 on bad
 * arguments, 3 if out of memory. */
int jpeg_encode(const uint8_t *img, int64_t h, int64_t w, int channels,
                int quality, uint8_t *out, int64_t cap, int64_t *out_len) {
  writer_t wr = {out, cap, 0, 0, 0, 0};
  quant_t ql, qc;
  ehuff_t dcl, acl, dcc, acc;
  const int grey = channels == 1;
  static const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1,
                                   0, 1, 0, 0};
  int64_t yw, yh, cw = 0, ch = 0, mcu_cols, mcu_rows;
  int64_t ywib, yhib;
  uint8_t *yp, *cbp = NULL, *crp = NULL;
  int32_t last_dc[3] = {0, 0, 0};

  if (h < 1 || w < 1 || h > 65535 || w > 65535 ||
      (channels != 1 && channels != 3))
    return 2;
  make_quant(std_q_luma_zz, quality, &ql);
  make_quant(std_q_chroma_zz, quality, &qc);
  derive(dht_dc_luma, &dcl);
  derive(dht_ac_luma, &acl);
  derive(dht_dc_chroma, &dcc);
  derive(dht_ac_chroma, &acc);

  /* the Y plane, whole blocks; the chroma planes, whole blocks of the
   * downsampled size */
  ywib = div_up(w, grey ? 8 : 8);
  yhib = div_up(h, 8);
  yw = ywib * 8;
  yh = yhib * 8;
  mcu_cols = grey ? ywib : div_up(w, 16);
  mcu_rows = grey ? yhib : div_up(h, 16);
  yp = (uint8_t *)malloc((size_t)(yw * yh));
  if (!yp) return 3;
  if (!grey) {
    cw = mcu_cols * 8;
    ch = mcu_rows * 8;
    cbp = (uint8_t *)malloc((size_t)(cw * ch));
    crp = (uint8_t *)malloc((size_t)(cw * ch));
    if (!cbp || !crp) { free(yp); free(cbp); free(crp); return 3; }
  }

  if (grey) {
    for (int64_t y = 0; y < h; y++) memcpy(yp + y * yw, img + y * w,
                                          (size_t)w);
    pad_plane(yp, w, h, yw, yh);
  } else {
    /* jccolor.c rgb_ycc_convert, row pairs at full width for the chroma
     * downsampler (the last row repeated to a whole pair, the right edge
     * to 2 * cw) */
    int32_t tab[8 * 256];
    const int32_t half = 1 << 15, cbcr = 128 << 16;
#define FIX(x) ((int32_t)((x) * 65536.0 + 0.5))
    for (int i = 0; i < 256; i++) {
      tab[i] = FIX(0.29900) * i;
      tab[i + 256] = FIX(0.58700) * i;
      tab[i + 512] = FIX(0.11400) * i + half;
      tab[i + 768] = (-FIX(0.16874)) * i;
      tab[i + 1024] = (-FIX(0.33126)) * i;
      tab[i + 1280] = FIX(0.50000) * i + cbcr + half - 1;
      tab[i + 1536] = (-FIX(0.41869)) * i;
      tab[i + 1792] = (-FIX(0.08131)) * i;
    }
#undef FIX
    int64_t fw = 2 * cw, crows = div_up(h, 2);
    uint8_t *cb2 = (uint8_t *)malloc((size_t)(2 * fw));
    uint8_t *cr2 = (uint8_t *)malloc((size_t)(2 * fw));
    if (!cb2 || !cr2) {
      free(yp); free(cbp); free(crp); free(cb2); free(cr2);
      return 3;
    }
    for (int64_t y = 0; y < h; y++) {
      const uint8_t *row = img + y * w * 3;
      uint8_t *cbr = cb2 + (y & 1) * fw, *crr = cr2 + (y & 1) * fw;
      for (int64_t x = 0; x < w; x++) {
        int r = row[3 * x], g = row[3 * x + 1], b = row[3 * x + 2];
        yp[y * yw + x] = (uint8_t)((tab[r] + tab[g + 256] + tab[b + 512])
                                   >> 16);
        cbr[x] = (uint8_t)((tab[r + 768] + tab[g + 1024] + tab[b + 1280])
                           >> 16);
        crr[x] = (uint8_t)((tab[r + 1280] + tab[g + 1536] + tab[b + 1792])
                           >> 16);
      }
      for (int64_t x = w; x < fw; x++) {
        cbr[x] = cbr[w - 1];
        crr[x] = crr[w - 1];
      }
      if ((y & 1) || y == h - 1) {
        if (!(y & 1)) {            /* an odd height: the last row twice */
          memcpy(cb2 + fw, cb2, (size_t)fw);
          memcpy(cr2 + fw, cr2, (size_t)fw);
        }
        int64_t cy = y >> 1;
        int bias = 1;
        for (int64_t x = 0; x < cw; x++) {
          cbp[cy * cw + x] = (uint8_t)((cb2[2 * x] + cb2[2 * x + 1] +
                                        cb2[fw + 2 * x] +
                                        cb2[fw + 2 * x + 1] + bias) >> 2);
          crp[cy * cw + x] = (uint8_t)((cr2[2 * x] + cr2[2 * x + 1] +
                                        cr2[fw + 2 * x] +
                                        cr2[fw + 2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
    free(cb2);
    free(cr2);
    pad_plane(yp, w, h, yw, yh);
    pad_plane(cbp, cw, crows, cw, ch);
    pad_plane(crp, cw, crows, cw, ch);
  }

  /* markers */
  put_u16(&wr, 0xFFD8);
  put_u16(&wr, 0xFFE0);
  put_u16(&wr, 16);
  put_bytes(&wr, jfif, 14);
  put_dqt(&wr, 0, &ql);
  if (!grey) put_dqt(&wr, 1, &qc);
  put_u16(&wr, 0xFFC0);
  put_u16(&wr, 8 + 3 * channels);
  put_byte(&wr, 8);
  put_u16(&wr, (int)h);
  put_u16(&wr, (int)w);
  put_byte(&wr, channels);
  for (int c = 0; c < channels; c++) {
    put_byte(&wr, c + 1);
    put_byte(&wr, grey ? 0x11 : (c == 0 ? 0x22 : 0x11));
    put_byte(&wr, c == 0 ? 0 : 1);
  }
  put_dht(&wr, 0x00, dht_dc_luma, sizeof(dht_dc_luma));
  put_dht(&wr, 0x10, dht_ac_luma, sizeof(dht_ac_luma));
  if (!grey) {
    put_dht(&wr, 0x01, dht_dc_chroma, sizeof(dht_dc_chroma));
    put_dht(&wr, 0x11, dht_ac_chroma, sizeof(dht_ac_chroma));
  }
  put_u16(&wr, 0xFFDA);
  put_u16(&wr, 6 + 2 * channels);
  put_byte(&wr, channels);
  for (int c = 0; c < channels; c++) {
    put_byte(&wr, c + 1);
    put_byte(&wr, c == 0 ? 0x00 : 0x11);
  }
  put_byte(&wr, 0);
  put_byte(&wr, 63);
  put_byte(&wr, 0);

  /* the scan: MCUs in raster order */
  for (int64_t my = 0; my < mcu_rows; my++) {
    for (int64_t mx = 0; mx < mcu_cols; mx++) {
      int32_t coef[64];
      if (grey) {
        forward_block(yp, yw, my * 8, mx * 8, &ql, coef);
        encode_block(&wr, coef, &last_dc[0], &dcl, &acl);
        continue;
      }
      int32_t blk[4][64];
      for (int yi = 0; yi < 2; yi++) {
        int64_t by = 2 * my + yi;
        for (int xi = 0; xi < 2; xi++) {
          int64_t bx = 2 * mx + xi;
          int32_t *b = blk[2 * yi + xi];
          if (by < yhib && bx < ywib) {
            forward_block(yp, yw, by * 8, bx * 8, &ql, b);
          } else {
            /* a dummy block: the DC of the block before it in the MCU
             * (for a dummy row, the last block of the row above) */
            memset(b, 0, sizeof(blk[0]));
            b[0] = by < yhib ? blk[2 * yi + xi - 1][0] : blk[1][0];
          }
        }
      }
      for (int i = 0; i < 4; i++)
        encode_block(&wr, blk[i], &last_dc[0], &dcl, &acl);
      forward_block(cbp, cw, my * 8, mx * 8, &qc, coef);
      encode_block(&wr, coef, &last_dc[1], &dcc, &acc);
      forward_block(crp, cw, my * 8, mx * 8, &qc, coef);
      encode_block(&wr, coef, &last_dc[2], &dcc, &acc);
    }
  }
  put_bits(&wr, 0x7F, 7);        /* pad the last byte with ones */
  put_u16(&wr, 0xFFD9);

  free(yp);
  free(cbp);
  free(crp);
  *out_len = wr.len;
  return wr.overflow ? 1 : 0;
}
