// Raft log replication under leader-crash chaos
// (madsim_tpu_torch/models/raftlog.py) as a model trait of the run
// kernel (engine_step.cuh): NS_ servers (n_nodes, five by default), eight
// handlers, four args words,
// and AppendEntries that carry the sender's whole log (four entries by
// default) in the event payload. Entries pack as value | term << 8.
// RaftLogModel<true> is the record variant (raftlog-record): an election
// win appends an OP_ELECT history record and a commit one OP_COMMIT
// record per newly committed index, LOGW record rows a call. CHAOS =
// false drops the seed's own kill and restart (a fault plan brings its
// own). DURABLE = true is durable=True: the Figure-2 columns under the
// sync discipline (SYNC), synced by every handler that dirties them and
// gated on ctx.sync_err; with RECORD also the OP_SYNCED and OP_RECOVER
// records. NOSYNC is the bug="nosync" mutant: the same columns, never
// synced. SPREAD is cov_spread=True: the commit-index spread as the
// model's coverage features (CovOf in engine_step.cuh). ARMY is the
// army=True variant: a sixth node, the client, runs no raft (no
// election timer, no records); three more handlers take a
// chaos.ClientArmy's ops there, each a dirty read of server op % 5's
// commit index, its invoke and completion marked for the latency tap
// (L = 1 marker row a call). NS is the servers, N every node. NWRITES is
// n_writes, the log's entries (LOGW): 4 by default, 16 in the causal
// soak's cone hunt.
#pragma once

#include "engine_step.cuh"

namespace madsim {

template <bool RECORD = false, bool CHAOS = true, bool DURABLE = false, bool NOSYNC = false,
          bool SPREAD = false, bool ARMY = false, int NWRITES = 4, int NS_ = 5>
struct RaftLogModel {
  static_assert(!NOSYNC || DURABLE, "the nosync mutant needs durable=True");
  static_assert(NS_ >= 1 && NS_ <= 31, "the ack mask holds every server");
  static constexpr int NS = NS_;              // servers
  static constexpr int N = NS + (ARMY ? 1 : 0);  // nodes: the army's client last
  static constexpr int LOGW = NWRITES;  // log entries (n_writes)
  static constexpr int U = 8 + LOGW, A = 4, W = LOGW, K = NS + 2, H = ARMY ? 11 : 8;
  static constexpr int R = RECORD ? LOGW : 0;  // history records per call
  static constexpr bool SYNC = DURABLE;  // the sync discipline
  // the correct placement syncs; the mutant never does
  static constexpr bool SYNC_EN = DURABLE && !NOSYNC;
  static constexpr bool REC_STORE = RECORD && DURABLE;
  static constexpr int32_t OP_ELECT = OP_USER, OP_COMMIT = OP_USER + 1,
                           OP_SYNCED = OP_USER + 2, OP_RECOVER = OP_USER + 3;
  static constexpr int32_t majority = NS / 2 + 1;
  static constexpr int L = ARMY ? 1 : 0;  // latency markers per call
  static constexpr int32_t CLIENT = NS;

  struct Params {
    int64_t timeout_min;
    uint32_t timeout_span;
    int64_t propose_ns, retx_ns;
  };
  static Params params(const int64_t* w) {
    return Params{w[0], draw_span(w[0], w[1]), w[2], w[3]};
  }

  static constexpr int32_t ROLE = 0, TERM = 1, VOTED = 2, VOTES = 3,
                           TSEQ = 4, LOGLEN = 5, COMMIT = 6, ACKS = 7,
                           LOG0 = 8;
  static constexpr int32_t FOLLOWER = 0, CANDIDATE = 1, LEADER = 2;

  // cov_spread: the servers' commit-index spread, and the (floor, spread)
  // pair with each field masked to its byte
  static constexpr int NCOV = SPREAD ? 2 : 0;
  static MADSIM_HDI void cov_features(const int32_t* ns, uint32_t* f) {
    int32_t lo = ns[COMMIT], hi = ns[COMMIT];
    for (int n = 1; n < NS; n++) {
      const int32_t c = ns[n * U + COMMIT];
      lo = c < lo ? c : lo;
      hi = c > hi ? c : hi;
    }
    const uint32_t spread = static_cast<uint32_t>(hi) - static_cast<uint32_t>(lo);
    f[0] = spread;
    f[1] = (static_cast<uint32_t>(lo) & 0xFFu) | ((spread & 0xFFu) << 8) | (1u << 16);
  }
  static constexpr int32_t K_TIMEOUT = FIRST_USER_KIND + 1;
  static constexpr int32_t K_REQVOTE = FIRST_USER_KIND + 2;
  static constexpr int32_t K_GRANT = FIRST_USER_KIND + 3;
  static constexpr int32_t K_APPEND = FIRST_USER_KIND + 4;
  static constexpr int32_t K_ACKAPP = FIRST_USER_KIND + 5;
  static constexpr int32_t K_PROPOSE = FIRST_USER_KIND + 6;
  static constexpr int32_t K_RETX = FIRST_USER_KIND + 7;
  static constexpr int32_t K_APROBE = FIRST_USER_KIND + 9;
  static constexpr int32_t K_ARESP = FIRST_USER_KIND + 10;
  static constexpr uint32_t P_TIMEOUT = 0, P_VALUE = 1, P_KILL_AT = 2,
                            P_KILL_WHO = 3, P_REVIVE = 4;

  using Em = Emit<A, W>;
  using C = Ctx<RaftLogModel>;

  // the node's observable fsync-EIO flag; false for the diskless and
  // nosync variants
  static MADSIM_HDI bool eio(const C& c) { return SYNC_EN && c.sync_err; }

  // term of the last log entry (0 for an empty log); value = low 8 bits,
  // term = the rest
  static MADSIM_HDI int32_t lastterm(const int32_t* st) {
    int32_t t = 0;
    for (int32_t j = 0; j < LOGW; j++)
      if (st[LOGLEN] == j + 1) t = st[LOG0 + j] >> 8;
    return t;
  }

  // an election timer row (user purpose 0), drawn only when it is valid
  static MADSIM_HDI void arm(Em& e, const C& c, const Params& p,
                             int32_t seq, bool when) {
    const int64_t d =
        when ? p.timeout_min + static_cast<int64_t>(c.user(P_TIMEOUT) % p.timeout_span)
             : 0;
    e.after(when, d, K_TIMEOUT, c.node, seq);
  }

  // rows 0..NS-1: AppendEntries (term, idx, commit, leader) with the
  // sender's whole log as payload, to every peer
  static MADSIM_HDI void send_appends(Em* em, const C& c, const int32_t* st,
                                      int32_t term, bool when) {
    for (int32_t q = 0; q < NS; q++) {
      em[q].to(when && q != c.node, q, K_APPEND, term, st[LOGLEN] - 1);
      em[q].args[2] = st[COMMIT];
      em[q].args[3] = c.node;
      for (int j = 0; j < W; j++) em[q].pay[j] = st[LOG0 + j];
    }
  }

  // the army handlers, 8..10: an op arrives at the client and probes
  // server op % NS; the server answers with its commit index (read
  // only); the response completes the op
  static MADSIM_HDI void army(int32_t h, const C& c, Em* em) {
    const int32_t op = c.args[0];
    if (h == 8) {
      c.lat_start(true, op);
      em[0].to(true, (op % NS + NS) % NS, K_APROBE, op);  // floor mod
    } else if (h == 9) {
      em[0].to(true, CLIENT, K_ARESP, op, c.state[COMMIT]);
    } else {
      c.lat_end(true, op);
    }
  }

  static MADSIM_HD void handle(int32_t h, const C& c, const Params& p,
                               int32_t* ns, Em* em, [[maybe_unused]] Rec* rec) {
    const int32_t* st = c.state;
    if constexpr (ARMY) {
      if (h >= 8) {
        army(h, c, em);
        return;
      }
    }
    switch (h) {
      case 0: {  // on_init
        // the army's client runs no raft
        const bool is_server = !ARMY || c.node < NS;
        arm(em[0], c, p, 1, is_server);
        // a re-init at now > 0 is a restart: the log length it recovered
        if constexpr (REC_STORE)
          rec[0].record(c.now > 0 && is_server, OP_RECOVER, 0, st[LOGLEN], OK_OK);
        // node 0's t=0 init schedules the seed's kill and restart
        // (restarted nodes re-run on_init at now > 0)
        if constexpr (CHAOS) {
          if (c.node == 0 && c.now == 0) {
            const int32_t who = static_cast<int32_t>(c.user_int(0, NS, P_KILL_WHO));
            const int64_t at = c.user_int(200000000, 500000000, P_KILL_AT);
            const int64_t revive = c.user_int(100000000, 600000000, P_REVIVE);
            em[1].after(true, at, KIND_KILL, 0, who);
            em[2].after(true, at + revive, KIND_RESTART, 0, who);
          }
        }
        ns[TSEQ] = 1;
        break;
      }
      case 1: {  // on_timeout: args = (timer_seq,)
        const bool due = c.args[0] == st[TSEQ] && st[ROLE] != LEADER;
        // a failing disk cannot persist the candidacy: re-arm the same seq
        const bool err = eio(c);
        const bool fire = due && !err;
        const int32_t term = st[TERM] + 1;
        if (fire) {
          ns[ROLE] = CANDIDATE;
          ns[TERM] = term;
          ns[VOTED] = term;
          ns[VOTES] = 1;
          ns[TSEQ] = st[TSEQ] + 1;
        }
        const int32_t lt = lastterm(st);
        for (int32_t q = 0; q < NS; q++) {
          em[q].to(fire && q != c.node, q, K_REQVOTE, term, c.node);
          em[q].args[2] = st[LOGLEN];
          em[q].args[3] = lt;
        }
        arm(em[NS], c, p, st[TSEQ] + 1, fire);
        arm(em[NS + 1], c, p, st[TSEQ], due && err);
        if constexpr (SYNC_EN) c.sync(fire);
        break;
      }
      case 2: {  // on_reqvote: args = (term, cand, cand_loglen, cand_lastterm)
        const int32_t term = c.args[0], cand = c.args[1];
        const int32_t c_len = c.args[2], c_lt = c.args[3];
        if (term > st[TERM]) {  // step down on a newer term
          ns[TERM] = term;
          ns[ROLE] = FOLLOWER;
          ns[VOTES] = 0;
        }
        // the up-to-date rule: candidate's (last term, length) >= ours
        const int32_t my_lt = lastterm(ns);
        const bool up_to_date = c_lt > my_lt || (c_lt == my_lt && c_len >= ns[LOGLEN]);
        const bool grant = term == ns[TERM] && ns[VOTED] < term && up_to_date && !eio(c);
        const int32_t tseq1 = ns[TSEQ] + 1;
        if (grant) {
          ns[VOTED] = term;
          ns[TSEQ] = tseq1;
        }
        em[0].to(grant, cand, K_GRANT, term);
        arm(em[1], c, p, tseq1, grant);
        if constexpr (SYNC_EN) c.sync(term > st[TERM] || grant);
        break;
      }
      case 3: {  // on_grant: args = (term,)
        const int32_t term = c.args[0];
        const bool counts = st[ROLE] == CANDIDATE && term == st[TERM];
        const int32_t votes = counts ? st[VOTES] + 1 : st[VOTES];
        const bool wins = counts && votes >= majority && !eio(c);
        ns[VOTES] = votes;
        if (wins) {
          ns[ROLE] = LEADER;
          // win-time re-stamp: the uncommitted suffix takes the new term
          for (int32_t j = 0; j < LOGW; j++)
            if (j >= ns[COMMIT] && j < ns[LOGLEN])
              ns[LOG0 + j] = (ns[LOG0 + j] & 0xFF) | (term << 8);
          ns[ACKS] = ns[LOGLEN] > ns[COMMIT] ? (int32_t(1) << c.node) : 0;
        }
        send_appends(em, c, ns, term, wins);
        em[NS].after(wins, p.propose_ns, K_PROPOSE, c.node, term);
        em[NS + 1].after(wins, p.retx_ns, K_RETX, c.node, term);
        if constexpr (RECORD) rec[0].record(wins, OP_ELECT, term, c.node, OK_OK);
        if constexpr (SYNC_EN) c.sync(wins);
        break;
      }
      case 4: {  // on_append: args = (term, idx, leader_commit, leader)
        const int32_t term = c.args[0], idx = c.args[1];
        const int32_t l_commit = c.args[2], leader = c.args[3];
        const bool ok = term >= st[TERM];
        if (ok) {
          ns[TERM] = term;
          ns[ROLE] = FOLLOWER;
          ns[TSEQ] = st[TSEQ] + 1;
        }
        // adopt the leader's full log prefix; a same-term append may
        // only extend
        const bool adopt = ok && idx >= 0 && (term > st[TERM] || idx + 1 >= st[LOGLEN]);
        if (adopt) {
          for (int32_t j = 0; j < LOGW; j++)
            if (j <= idx) ns[LOG0 + j] = c.pay[j];
          ns[LOGLEN] = idx + 1;
        }
        if (ok && l_commit > ns[COMMIT]) ns[COMMIT] = l_commit;
        // inside an EIO window the ack waits for a retransmission
        const bool err = eio(c);
        em[0].to(adopt && !err, leader, K_ACKAPP, term, idx);
        em[0].args[2] = c.node;
        // a heartbeat resets the election timer
        arm(em[1], c, p, st[TSEQ] + 1, ok);
        if constexpr (SYNC_EN) c.sync(ok);
        if constexpr (REC_STORE && SYNC_EN)
          rec[0].record(adopt && !err && idx + 1 != st[LOGLEN], OP_SYNCED, 0, idx + 1, OK_OK);
        break;
      }
      case 5: {  // on_ackapp: args = (term, idx, follower)
        const int32_t term = c.args[0], idx = c.args[1], frm = c.args[2];
        const bool counts = st[ROLE] == LEADER && term == st[TERM] &&
                            idx == st[LOGLEN] - 1 && st[COMMIT] < st[LOGLEN];
        const int32_t acks = counts ? (st[ACKS] | (int32_t(1) << frm)) : st[ACKS];
        int32_t n_acks = 0;
        for (int32_t q = 0; q < NS; q++) n_acks += (acks >> q) & 1;
        const bool commit_now = counts && n_acks >= majority;
        ns[ACKS] = acks;
        if (commit_now) ns[COMMIT] = idx + 1;
        // propagate the commit index immediately
        send_appends(em, c, ns, term, commit_now);
        // one event per newly committed index, with the entry's value byte
        if constexpr (RECORD)
          for (int32_t j = 0; j < LOGW; j++)
            rec[j].record(commit_now && j >= st[COMMIT] && j <= idx, OP_COMMIT, j,
                          ns[LOG0 + j] & 0xFF, OK_OK);
        em[NS].after(commit_now && ns[COMMIT] == LOGW, 0, KIND_HALT, 0);
        break;
      }
      case 6: {  // on_propose: args = (term,)
        const int32_t term = c.args[0];
        const bool alive_leader = st[ROLE] == LEADER && term == st[TERM];
        const bool can =
            alive_leader && st[COMMIT] == st[LOGLEN] && st[LOGLEN] < LOGW && !eio(c);
        if (can) {
          const int32_t value = static_cast<int32_t>(c.user(P_VALUE) & 0xFFu);
          for (int32_t j = 0; j < LOGW; j++)
            if (st[LOGLEN] == j) ns[LOG0 + j] = value | (st[TERM] << 8);
          ns[LOGLEN] = st[LOGLEN] + 1;
          ns[ACKS] = int32_t(1) << c.node;
        }
        send_appends(em, c, ns, term, can);
        em[NS].after(alive_leader, p.propose_ns, K_PROPOSE, c.node, term);
        if constexpr (SYNC_EN) c.sync(can);
        if constexpr (REC_STORE && SYNC_EN)
          rec[0].record(can, OP_SYNCED, 0, st[LOGLEN] + 1, OK_OK);
        break;
      }
      default: {  // 7, on_retx: args = (term,)
        const int32_t term = c.args[0];
        const bool alive_leader = st[ROLE] == LEADER && term == st[TERM];
        // re-replicate whatever is outstanding; doubles as the heartbeat
        send_appends(em, c, st, term, alive_leader && st[LOGLEN] > 0);
        em[NS].after(alive_leader, p.retx_ns, K_RETX, c.node, term);
        break;
      }
    }
  }
};

}  // namespace madsim
