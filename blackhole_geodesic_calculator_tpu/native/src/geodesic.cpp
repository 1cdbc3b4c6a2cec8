/* Double-precision adaptive Dormand-Prince 5(4) null-geodesic integrator.
 *
 * The native equivalent of the layer the reference delegates to scipy's
 * compiled RK45 core (solve_ivp, one call per pixel at
 * raytracer/RelativisticRenderEngine.py:293-294; the 8-ODE system of
 * README.md:196-211).  Same Hamiltonian Kerr-Schild formulation as the JAX
 * path (ops/geodesic.py): 6 ODEs in (x_i, p_i) with the photon energy
 * E = -p_t exactly conserved, horizon-penetrating coordinates, and the same
 * event/termination taxonomy as ops/integrate.py (capture / escape / affine
 * budget / disk crossing / sphere hit / error).
 *
 * Used from Python (ctypes) as (a) the f64 validation oracle the
 * kernel/XLA device paths are tested against, (b) the trajectory-polyline backend
 * for the curvedpy-compat API, multithreaded over rays.
 */
#include "bgc.h"

#include <atomic>
#include <cmath>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr double kR2Floor = 1e-12;  // ops/geodesic.py _R2_FLOOR

struct Vec3 {
  double v[3];
  double& operator[](int i) { return v[i]; }
  double operator[](int i) const { return v[i]; }
};

inline double dot(const Vec3& a, const Vec3& b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

/* ---- Kerr-Schild scalars (models/kerr.py ks_radius / ks_scalars) ---- */

inline double ks_radius(const Vec3& x, double a) {
  double rho2 = dot(x, x);
  if (a == 0.0) return std::sqrt(std::max(rho2, kR2Floor));
  double bq = rho2 - a * a;
  double S = std::sqrt(bq * bq + 4.0 * a * a * x[2] * x[2]);
  double r2 = 0.5 * (bq + S);
  return std::sqrt(std::max(r2, kR2Floor));
}

/* q = 2H, l, r at x. */
inline void ks_fields(const Vec3& x, double mass, double a,
                      double* q, Vec3* l, double* r_out) {
  if (a == 0.0) {
    double r2 = std::max(dot(x, x), kR2Floor);
    double inv_r = 1.0 / std::sqrt(r2);
    *q = 2.0 * mass * inv_r;
    (*l)[0] = x[0] * inv_r;
    (*l)[1] = x[1] * inv_r;
    (*l)[2] = x[2] * inv_r;
    *r_out = r2 * inv_r;
    return;
  }
  double r = ks_radius(x, a);
  double A = r * r + a * a;
  (*l)[0] = (r * x[0] + a * x[1]) / A;
  (*l)[1] = (r * x[1] - a * x[0]) / A;
  (*l)[2] = x[2] / r;
  double D = r * r * r * r + a * a * x[2] * x[2];
  *q = 2.0 * mass * r * r * r / D;
  *r_out = r;
}

/* dx = p - q w l ; dp = +d/dx [H w^2], w = E + l.p  (ops/geodesic.ks_rhs).
 * For a != 0 the gradient is evaluated analytically via implicit
 * differentiation of the Kerr-Schild radius:
 *   dr/dx_i = (r^2 x_i + a^2 z delta_i2) / (r S),
 *   S = sqrt((rho^2-a^2)^2 + 4 a^2 z^2) = 2 r^2 - (rho^2 - a^2).   */
void rhs(const Vec3& x, const Vec3& p, double E, double mass, double a,
         Vec3* dx, Vec3* dp) {
  if (a == 0.0) {
    /* Hand-derived Schwarzschild form (ops/geodesic.schwarzschild_rhs). */
    double r2 = std::max(dot(x, x), kR2Floor);
    double inv_r = 1.0 / std::sqrt(r2);
    double inv_r2 = inv_r * inv_r;
    Vec3 n{{x[0] * inv_r, x[1] * inv_r, x[2] * inv_r}};
    double u = 2.0 * mass * inv_r;
    double s = dot(n, p);
    double w = E + s;
    double m_r2 = mass * inv_r2;
    double cp = 2.0 * m_r2 * w;
    double cn = m_r2 * w * (w + 2.0 * s);
    for (int i = 0; i < 3; ++i) {
      (*dx)[i] = p[i] - u * w * n[i];
      (*dp)[i] = cp * p[i] - cn * n[i];
    }
    return;
  }

  double rho2 = dot(x, x);
  double bq = rho2 - a * a;
  double z = x[2];
  double S = std::sqrt(bq * bq + 4.0 * a * a * z * z);
  double r2 = std::max(0.5 * (bq + S), kR2Floor);
  double r = std::sqrt(r2);
  double rS = std::max(r * S, kR2Floor);

  Vec3 dr;  /* dr/dx_i */
  for (int i = 0; i < 3; ++i)
    dr[i] = (r2 * x[i] + (i == 2 ? a * a * z : 0.0)) / rS;

  double A = r2 + a * a;
  Vec3 l{{(r * x[0] + a * x[1]) / A, (r * x[1] - a * x[0]) / A, z / r}};
  double D = r2 * r2 + a * a * z * z;
  double H = mass * r * r2 / D;
  double w = E + dot(l, p);

  /* dH/dx_i = M (3 r^2 D - 4 r^6) dr_i / D^2 - 2 M a^2 z r^3 delta_i2 / D^2 */
  double D2 = D * D;
  double hcoef = mass * (3.0 * r2 * D - 4.0 * r2 * r2 * r2) / D2;
  Vec3 dH{{hcoef * dr[0], hcoef * dr[1],
           hcoef * dr[2] - 2.0 * mass * a * a * z * r * r2 / D2}};

  /* dl_j/dx_i contracted with p: dw_i = p_j dl_j/dx_i. */
  double twoR_A2 = 2.0 * r / (A * A);
  Vec3 dw;
  for (int i = 0; i < 3; ++i) {
    /* l0 = (r x + a y)/A: quotient rule, dA/dx_i = 2 r dr_i */
    double num0 = dr[i] * x[0] + (i == 0 ? r : 0.0) + (i == 1 ? a : 0.0);
    double dl0 = num0 / A - (r * x[0] + a * x[1]) * twoR_A2 * dr[i];
    /* l1 = (r y - a x)/A */
    double num1 = dr[i] * x[1] + (i == 1 ? r : 0.0) - (i == 0 ? a : 0.0);
    double dl1 = num1 / A - (r * x[1] - a * x[0]) * twoR_A2 * dr[i];
    /* l2 = z/r */
    double dl2 = (i == 2 ? 1.0 / r : 0.0) - z * dr[i] / r2;
    dw[i] = p[0] * dl0 + p[1] * dl1 + p[2] * dl2;
  }

  double q = 2.0 * H;
  for (int i = 0; i < 3; ++i) {
    (*dx)[i] = p[i] - q * w * l[i];
    (*dp)[i] = w * w * dH[i] + q * w * dw[i];
  }
}

/* Initial (p, E) from the null condition (ops/geodesic.null_init). */
void null_init(const Vec3& x, const Vec3& d, double mass, double a,
               Vec3* p, double* E_out) {
  double q, r;
  Vec3 l;
  ks_fields(x, mass, a, &q, &l, &r);
  double s = dot(l, d);
  double e2 = 1.0 - q * (1.0 - s * s);
  double E = e2 > 0.0 ? std::sqrt(e2) : 0.0;
  double w = (E + s) / (1.0 - q);
  for (int i = 0; i < 3; ++i) (*p)[i] = d[i] + q * w * l[i];
  *E_out = E;
}

/* ---- Dormand-Prince 5(4) tableau (scipy RK45's method) ---- */

constexpr double A21 = 1.0 / 5.0;
constexpr double A31 = 3.0 / 40.0, A32 = 9.0 / 40.0;
constexpr double A41 = 44.0 / 45.0, A42 = -56.0 / 15.0, A43 = 32.0 / 9.0;
constexpr double A51 = 19372.0 / 6561.0, A52 = -25360.0 / 2187.0,
                 A53 = 64448.0 / 6561.0, A54 = -212.0 / 729.0;
constexpr double A61 = 9017.0 / 3168.0, A62 = -355.0 / 33.0,
                 A63 = 46732.0 / 5247.0, A64 = 49.0 / 176.0,
                 A65 = -5103.0 / 18656.0;
constexpr double B1 = 35.0 / 384.0, B3 = 500.0 / 1113.0, B4 = 125.0 / 192.0,
                 B5 = -2187.0 / 6784.0, B6 = 11.0 / 84.0;
/* e = b - bhat (embedded 4th order), scipy _ivp/rk.py */
constexpr double E1 = 71.0 / 57600.0, E3 = -71.0 / 16695.0, E4 = 71.0 / 1920.0,
                 E5 = -17253.0 / 339200.0, E6 = 22.0 / 525.0, E7 = -1.0 / 40.0;

struct State {
  Vec3 x, p;
};

inline void axpy6(State* out, const State& y, double c, const State& k) {
  for (int i = 0; i < 3; ++i) {
    out->x[i] = y.x[i] + c * k.x[i];
    out->p[i] = y.p[i] + c * k.p[i];
  }
}

struct RayResult {
  State y;
  double lam;
  int32_t status;
  int32_t hit_obj;
  int32_t n_steps;
};

/* Callback invoked after each ACCEPTED step; may be null. */
typedef void (*StepSink)(void* ctx, const State& y, double lam);

/* Integrate one ray.  The event taxonomy and ordering match
 * ops/pallas_kernel._soa_step exactly (budget < escape < capture < error,
 * then sphere hits, then disk if it happens earlier along the segment). */
RayResult integrate_one(const Vec3& x0, const Vec3& d0, const BgcEnv& env,
                        const BgcSolverOpts& o, StepSink sink, void* ctx) {
  const double rtol = o.rtol > 0 ? o.rtol : 1e-8;
  const double atol = o.atol > 0 ? o.atol : 1e-10;
  const double hmax =
      o.max_step > 0 ? o.max_step : std::numeric_limits<double>::infinity();
  const double hmin = o.min_step > 0 ? o.min_step : 1e-12;
  const long max_evals = o.max_evals > 0 ? o.max_evals : 10000000L;
  const bool has_disk = env.disk_r_out > 0.0;
  const double a = env.spin;

  RayResult res;
  res.lam = 0.0;
  res.status = BGC_ACTIVE;
  res.hit_obj = -1;
  res.n_steps = 0;

  double E;
  null_init(x0, d0, env.mass, a, &res.y.p, &E);
  res.y.x = x0;

  double r0 = ks_radius(x0, a);
  if (r0 <= env.r_capture) {  /* reference start_inside_hole */
    res.status = BGC_INSIDE_HORIZON;
    return res;
  }

  State y = res.y;
  State k1;
  rhs(y.x, y.p, E, env.mass, a, &k1.x, &k1.p);
  long evals = 1;

  /* Initial step: scipy-style heuristic on the scaled state/derivative. */
  double d0n = 0.0, d1n = 0.0;
  for (int i = 0; i < 3; ++i) {
    double sx = atol + rtol * std::fabs(y.x[i]);
    double sp = atol + rtol * std::fabs(y.p[i]);
    d0n += (y.x[i] / sx) * (y.x[i] / sx) + (y.p[i] / sp) * (y.p[i] / sp);
    d1n += (k1.x[i] / sx) * (k1.x[i] / sx) + (k1.p[i] / sp) * (k1.p[i] / sp);
  }
  d0n = std::sqrt(d0n / 6.0);
  d1n = std::sqrt(d1n / 6.0);
  double h = (d0n < 1e-5 || d1n < 1e-5) ? 1e-6 : 0.01 * d0n / d1n;
  if (o.first_step > 0) h = o.first_step;
  h = std::min(h, hmax);

  State k2, k3, k4, k5, k6, k7, yt, y1;

  while (res.status == BGC_ACTIVE) {
    if (evals + 6 > max_evals) {
      res.status = BGC_ERROR; /* budget exhausted: reference 'error' taxonomy */
      break;
    }
    /* -- one DP45 attempt -- */
    axpy6(&yt, y, h * A21, k1);
    rhs(yt.x, yt.p, E, env.mass, a, &k2.x, &k2.p);
    for (int i = 0; i < 3; ++i) {
      yt.x[i] = y.x[i] + h * (A31 * k1.x[i] + A32 * k2.x[i]);
      yt.p[i] = y.p[i] + h * (A31 * k1.p[i] + A32 * k2.p[i]);
    }
    rhs(yt.x, yt.p, E, env.mass, a, &k3.x, &k3.p);
    for (int i = 0; i < 3; ++i) {
      yt.x[i] = y.x[i] + h * (A41 * k1.x[i] + A42 * k2.x[i] + A43 * k3.x[i]);
      yt.p[i] = y.p[i] + h * (A41 * k1.p[i] + A42 * k2.p[i] + A43 * k3.p[i]);
    }
    rhs(yt.x, yt.p, E, env.mass, a, &k4.x, &k4.p);
    for (int i = 0; i < 3; ++i) {
      yt.x[i] = y.x[i] + h * (A51 * k1.x[i] + A52 * k2.x[i] + A53 * k3.x[i] +
                              A54 * k4.x[i]);
      yt.p[i] = y.p[i] + h * (A51 * k1.p[i] + A52 * k2.p[i] + A53 * k3.p[i] +
                              A54 * k4.p[i]);
    }
    rhs(yt.x, yt.p, E, env.mass, a, &k5.x, &k5.p);
    for (int i = 0; i < 3; ++i) {
      yt.x[i] = y.x[i] + h * (A61 * k1.x[i] + A62 * k2.x[i] + A63 * k3.x[i] +
                              A64 * k4.x[i] + A65 * k5.x[i]);
      yt.p[i] = y.p[i] + h * (A61 * k1.p[i] + A62 * k2.p[i] + A63 * k3.p[i] +
                              A64 * k4.p[i] + A65 * k5.p[i]);
    }
    rhs(yt.x, yt.p, E, env.mass, a, &k6.x, &k6.p);
    for (int i = 0; i < 3; ++i) {
      y1.x[i] = y.x[i] + h * (B1 * k1.x[i] + B3 * k3.x[i] + B4 * k4.x[i] +
                              B5 * k5.x[i] + B6 * k6.x[i]);
      y1.p[i] = y.p[i] + h * (B1 * k1.p[i] + B3 * k3.p[i] + B4 * k4.p[i] +
                              B5 * k5.p[i] + B6 * k6.p[i]);
    }
    rhs(y1.x, y1.p, E, env.mass, a, &k7.x, &k7.p); /* FSAL */
    evals += 6;

    /* -- error norm (scipy RK45: RMS of err/scale) -- */
    double err = 0.0;
    bool finite = true;
    for (int i = 0; i < 3; ++i) {
      double ex = h * (E1 * k1.x[i] + E3 * k3.x[i] + E4 * k4.x[i] +
                       E5 * k5.x[i] + E6 * k6.x[i] + E7 * k7.x[i]);
      double ep = h * (E1 * k1.p[i] + E3 * k3.p[i] + E4 * k4.p[i] +
                       E5 * k5.p[i] + E6 * k6.p[i] + E7 * k7.p[i]);
      double sx =
          atol + rtol * std::max(std::fabs(y.x[i]), std::fabs(y1.x[i]));
      double sp =
          atol + rtol * std::max(std::fabs(y.p[i]), std::fabs(y1.p[i]));
      err += (ex / sx) * (ex / sx) + (ep / sp) * (ep / sp);
      finite = finite && std::isfinite(y1.x[i]) && std::isfinite(y1.p[i]);
    }
    err = std::sqrt(err / 6.0);

    if (!finite) {
      res.status = BGC_ERROR;
      res.y = y;  /* freeze at last good state */
      break;
    }
    if (err > 1.0 && h > hmin) { /* reject: shrink and retry */
      h = std::max(hmin, h * std::max(0.2, 0.9 * std::pow(err, -0.2)));
      continue;
    }

    /* -- accepted: events on the segment chord y -> y1 -- */
    double lam1 = res.lam + h;
    double t_disk = std::numeric_limits<double>::infinity();
    double disk_px = 0, disk_py = 0;
    if (has_disk) {
      bool crossed = (y1.x[2] < 0 && y.x[2] >= 0) || (y1.x[2] > 0 && y.x[2] <= 0);
      if (crossed) {
        double denom = y1.x[2] - y.x[2];
        double t = denom != 0.0 ? -y.x[2] / denom : 0.0;
        double px = y.x[0] + (y1.x[0] - y.x[0]) * t;
        double py = y.x[1] + (y1.x[1] - y.x[1]) * t;
        double rr = std::sqrt(px * px + py * py);
        if (rr >= env.disk_r_in && rr <= env.disk_r_out) {
          t_disk = t;
          disk_px = px;
          disk_py = py;
        }
      }
    }
    double t_sph = std::numeric_limits<double>::infinity();
    int sph_id = -1;
    Vec3 dxs{{y1.x[0] - y.x[0], y1.x[1] - y.x[1], y1.x[2] - y.x[2]}};
    if (env.n_spheres > 0) {
      double aa = dot(dxs, dxs);
      if (aa > 0) {
        for (int k = 0; k < env.n_spheres; ++k) {
          const double* s = env.spheres + 4 * k;
          Vec3 o3{{y.x[0] - s[0], y.x[1] - s[1], y.x[2] - s[2]}};
          double bb = 2.0 * dot(o3, dxs);
          double cc = dot(o3, o3) - s[3] * s[3];
          double disc = bb * bb - 4.0 * aa * cc;
          if (disc > 0) {
            double t = (-bb - std::sqrt(disc)) / (2.0 * aa);
            if (t >= 0.0 && t <= 1.0 && t < t_sph) {
              t_sph = t;
              sph_id = k;
            }
          }
        }
      }
    }

    double rb = ks_radius(y1.x, a);
    int32_t st = BGC_ACTIVE;
    if (lam1 >= env.lam_max) st = BGC_BUDGET;
    if (rb >= env.r_escape) st = BGC_ESCAPED;
    if (rb <= env.r_capture) st = BGC_CAPTURED;
    if (sph_id >= 0) st = BGC_OBJECT;
    if (t_disk <= t_sph && std::isfinite(t_disk)) st = BGC_DISK;

    if (st == BGC_OBJECT) {
      for (int i = 0; i < 3; ++i) y1.x[i] = y.x[i] + dxs[i] * t_sph;
      lam1 = res.lam + h * t_sph;
      res.hit_obj = sph_id;
    } else if (st == BGC_DISK) {
      y1.x[0] = disk_px;
      y1.x[1] = disk_py;
      y1.x[2] = 0.0;
      lam1 = res.lam + h * t_disk;
    }

    y = y1;
    k1 = k7; /* FSAL reuse */
    res.lam = lam1;
    res.status = st;
    res.n_steps += 1;
    if (sink) sink(ctx, y, lam1);

    /* -- PI-free step growth (scipy: safety 0.9, clip [0.2, 10]) -- */
    double factor =
        err == 0.0 ? 10.0 : std::min(10.0, std::max(0.2, 0.9 * std::pow(err, -0.2)));
    h = std::min(hmax, h * factor);
    if (h < hmin) h = hmin;
  }

  res.y = y;
  return res;
}

}  // namespace

extern "C" {

void bgc_rhs(const double* x, const double* p, double E, double mass,
             double spin, double* dx, double* dp) {
  Vec3 xv{{x[0], x[1], x[2]}}, pv{{p[0], p[1], p[2]}}, dxv, dpv;
  rhs(xv, pv, E, mass, spin, &dxv, &dpv);
  for (int i = 0; i < 3; ++i) {
    dx[i] = dxv[i];
    dp[i] = dpv[i];
  }
}

void bgc_rhs_batch(const double* x, const double* p, int64_t n, double E,
                   double mass, double spin, double* dx, double* dp) {
  for (int64_t i = 0; i < n; ++i) {
    Vec3 xv{{x[3 * i], x[3 * i + 1], x[3 * i + 2]}};
    Vec3 pv{{p[3 * i], p[3 * i + 1], p[3 * i + 2]}};
    Vec3 dxv, dpv;
    rhs(xv, pv, E, mass, spin, &dxv, &dpv);
    for (int j = 0; j < 3; ++j) {
      dx[3 * i + j] = dxv[j];
      dp[3 * i + j] = dpv[j];
    }
  }
}

void bgc_null_init(const double* x, const double* d, double mass, double spin,
                   double* p_out, double* E_out) {
  Vec3 xv{{x[0], x[1], x[2]}}, dv{{d[0], d[1], d[2]}}, pv;
  double E;
  null_init(xv, dv, mass, spin, &pv, &E);
  for (int i = 0; i < 3; ++i) p_out[i] = pv[i];
  *E_out = E;
}

int bgc_integrate_batch(const double* x0, const double* d0, int64_t n,
                        const BgcEnv* env, const BgcSolverOpts* opts,
                        int n_threads, double* x_out, double* p_out,
                        double* lam_out, int32_t* status_out,
                        int32_t* hit_obj_out, int32_t* n_steps_out) {
  if (!x0 || !d0 || !env || !opts || n < 0) return 1;
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > n) nt = (int)std::max<int64_t>(1, n);

  std::atomic<int64_t> next(0);
  auto work = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(64);
      if (i >= n) return;
      int64_t end = std::min<int64_t>(n, i + 64);
      for (; i < end; ++i) {
        Vec3 xv{{x0[3 * i], x0[3 * i + 1], x0[3 * i + 2]}};
        Vec3 dv{{d0[3 * i], d0[3 * i + 1], d0[3 * i + 2]}};
        RayResult r = integrate_one(xv, dv, *env, *opts, nullptr, nullptr);
        for (int j = 0; j < 3; ++j) {
          x_out[3 * i + j] = r.y.x[j];
          p_out[3 * i + j] = r.y.p[j];
        }
        lam_out[i] = r.lam;
        status_out[i] = r.status;
        hit_obj_out[i] = r.hit_obj;
        if (n_steps_out) n_steps_out[i] = r.n_steps;
      }
    }
  };

  if (nt == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  return 0;
}

namespace {
struct TrajCtx {
  double* tx;
  double* tp;
  double* tl;
  int32_t cap;
  int32_t count;
};

void traj_sink(void* vctx, const State& y, double lam) {
  TrajCtx* c = (TrajCtx*)vctx;
  int32_t i = c->count < c->cap ? c->count : c->cap - 1;
  for (int j = 0; j < 3; ++j) {
    c->tx[3 * i + j] = y.x[j];
    c->tp[3 * i + j] = y.p[j];
  }
  c->tl[i] = lam;
  if (c->count < c->cap) c->count += 1;
}
}  // namespace

namespace {
/* Sink recording position + coordinate VELOCITY (dx/dlambda = the x-part
 * of the RHS) per accepted step -- what the curvedpy-compat
 * calc_trajectory contract hands back as k (compat.py). */
struct TrajVCtx {
  const BgcEnv* env;
  double E;
  double* tx;
  double* tv;
  double* tl;
  int32_t cap;
  int32_t count;
};

void trajv_sink(void* vctx, const State& y, double lam) {
  TrajVCtx* c = (TrajVCtx*)vctx;
  int32_t i = c->count < c->cap ? c->count : c->cap - 1;
  Vec3 dx, dp;
  rhs(y.x, y.p, c->E, c->env->mass, c->env->spin, &dx, &dp);
  for (int j = 0; j < 3; ++j) {
    c->tx[3 * i + j] = y.x[j];
    c->tv[3 * i + j] = dx[j];
  }
  c->tl[i] = lam;
  if (c->count < c->cap) c->count += 1;
}
}  // namespace

int bgc_trajectory_batch(const double* x0, const double* d0, int64_t n,
                         const BgcEnv* env, const BgcSolverOpts* opts,
                         int32_t max_points, int n_threads,
                         double* traj_x, double* traj_v, double* traj_lam,
                         int32_t* n_points_out, double* lam_out,
                         int32_t* status_out, int32_t* hit_obj_out,
                         double* E_out) {
  if (!x0 || !d0 || !env || !opts || n < 0 || max_points < 1) return 1;
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > n) nt = (int)std::max<int64_t>(1, n);

  std::atomic<int64_t> next(0);
  auto work = [&]() {
    for (;;) {
      /* chunks of 4: dense-trajectory rays are heavyweight (an ODE solve
       * plus a polyline write each), so fine-grained stealing balances
       * capture-fast vs grazing-slow rays better than integrate_batch's
       * 64-ray chunks. */
      int64_t i = next.fetch_add(4);
      if (i >= n) return;
      int64_t end = std::min<int64_t>(n, i + 4);
      for (; i < end; ++i) {
        Vec3 xv{{x0[3 * i], x0[3 * i + 1], x0[3 * i + 2]}};
        Vec3 dv{{d0[3 * i], d0[3 * i + 1], d0[3 * i + 2]}};
        Vec3 p0;
        double E;
        null_init(xv, dv, env->mass, env->spin, &p0, &E);
        TrajVCtx ctx{env, E,
                     traj_x + (int64_t)3 * max_points * i,
                     traj_v + (int64_t)3 * max_points * i,
                     traj_lam + (int64_t)max_points * i, max_points, 0};
        State s0{xv, p0};
        trajv_sink(&ctx, s0, 0.0);  /* point 0 = launch state */
        RayResult r = integrate_one(xv, dv, *env, *opts, trajv_sink, &ctx);
        n_points_out[i] = ctx.count;
        if (lam_out) lam_out[i] = r.lam;
        status_out[i] = r.status;
        if (hit_obj_out) hit_obj_out[i] = r.hit_obj;
        if (E_out) E_out[i] = E;
      }
    }
  };

  if (nt == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
  }
  return 0;
}

int bgc_trajectory(const double* x0, const double* d0, const BgcEnv* env,
                   const BgcSolverOpts* opts, int32_t max_points,
                   double* traj_x, double* traj_p, double* traj_lam,
                   int32_t* n_points, double* lam_out, int32_t* hit_obj_out) {
  if (!x0 || !d0 || !env || !opts || max_points < 1) return BGC_ERROR;
  Vec3 xv{{x0[0], x0[1], x0[2]}}, dv{{d0[0], d0[1], d0[2]}};
  TrajCtx ctx{traj_x, traj_p, traj_lam, max_points, 0};
  /* point 0 = the launch state */
  Vec3 p0;
  double E;
  null_init(xv, dv, env->mass, env->spin, &p0, &E);
  State s0{xv, p0};
  traj_sink(&ctx, s0, 0.0);
  RayResult r = integrate_one(xv, dv, *env, *opts, traj_sink, &ctx);
  *n_points = ctx.count;
  if (lam_out) *lam_out = r.lam;
  if (hit_obj_out) *hit_obj_out = r.hit_obj;
  return r.status;
}

}  // extern "C"
