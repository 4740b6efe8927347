// glam_native: C++ data-path kernels for the glam_tpu framework.
//
// The reference implementation delegates its host-side chemistry to
// RDKit's C++ toolkit and its batching to PyG's C collation; this
// library is the first-party equivalent for glam_tpu: a SMILES
// parser + featurizer and an ELLPACK batch builder, exposed through a
// plain C ABI consumed via ctypes (glam_tpu/chem/native.py).  Semantics
// mirror glam_tpu/chem/smiles.py + featurize.py exactly — the Python
// implementation is the correctness oracle in tests/test_native.py.
//
// Build: see native/build.sh (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <set>
#include <string>
#include <vector>

namespace {

constexpr int SINGLE = 1, DOUBLE = 2, TRIPLE = 3, AROMATIC = 4;

double bond_order(int t) { return t == AROMATIC ? 1.5 : (double)t; }

struct Atom {
  std::string symbol;
  bool aromatic = false;
  int charge = 0;
  int explicit_h = -1;  // -1: implicit
  bool in_bracket = false;
  int num_h = 0;
  int hybridization = 0;  // 0 other, 1 SP, 2 SP2, 3 SP3
  std::vector<int> bonds;
};

struct Bond {
  int a, b, order;
  int other(int i) const { return i == a ? b : a; }
};

struct Mol {
  std::vector<Atom> atoms;
  std::vector<Bond> bonds;
};

const std::set<std::string> kTwoLetter = {
    "Cl", "Br", "Si", "Se", "As", "Na", "Li", "Mg", "Ca", "Al", "Fe",
    "Zn", "Cu", "Mn", "Sn", "Pb", "Hg", "Pt", "Au", "Ag", "Cd", "Cr",
    "Co", "Ni", "Ba", "Bi", "Sr", "Tl", "Te", "Sb", "In", "Ge", "Ga",
    "Mo", "Ru", "Rh", "Pd", "Kr", "Xe", "Rb", "Cs", "Be", "Ne", "Ar",
    "He"};

const std::map<std::string, int> kAtomicNum = {
    {"H", 1},   {"He", 2},  {"Li", 3},  {"Be", 4},  {"B", 5},
    {"C", 6},   {"N", 7},   {"O", 8},   {"F", 9},   {"Ne", 10},
    {"Na", 11}, {"Mg", 12}, {"Al", 13}, {"Si", 14}, {"P", 15},
    {"S", 16},  {"Cl", 17}, {"Ar", 18}, {"K", 19},  {"Ca", 20},
    {"Cr", 24}, {"Mn", 25}, {"Fe", 26}, {"Co", 27}, {"Ni", 28},
    {"Cu", 29}, {"Zn", 30}, {"Ga", 31}, {"Ge", 32}, {"As", 33},
    {"Se", 34}, {"Br", 35}, {"Kr", 36}, {"Rb", 37}, {"Sr", 38},
    {"Mo", 42}, {"Ru", 44}, {"Rh", 45}, {"Pd", 46}, {"Ag", 47},
    {"Cd", 48}, {"In", 49}, {"Sn", 50}, {"Sb", 51}, {"Te", 52},
    {"I", 53},  {"Xe", 54}, {"Cs", 55}, {"Ba", 56}, {"Pt", 78},
    {"Au", 79}, {"Hg", 80}, {"Tl", 81}, {"Pb", 82}, {"Bi", 83}};

const std::map<std::string, std::vector<int>> kValences = {
    {"B", {3}},  {"C", {4}},       {"N", {3}},  {"O", {2}},
    {"P", {3, 5}}, {"S", {2, 4, 6}}, {"F", {1}},  {"Cl", {1}},
    {"Br", {1}}, {"I", {1}},       {"H", {1}}};

const std::map<std::string, int> kValenceElectrons = {
    {"H", 1}, {"B", 3}, {"C", 4}, {"Si", 4}, {"N", 5},  {"P", 5},
    {"As", 5}, {"O", 6}, {"S", 6}, {"Se", 6}, {"Te", 6}, {"F", 7},
    {"Cl", 7}, {"Br", 7}, {"I", 7}};

// RDKit-parity maximum permitted valence (mirrors smiles.py
// _MAX_VALENCE byte-exactly; elements absent are unchecked, like
// RDKit's -1 "no limit" entries).
const std::map<std::string, int> kMaxValence = {
    {"H", 1},  {"He", 0}, {"Li", 1}, {"Be", 2}, {"B", 3},  {"C", 4},
    {"N", 3},  {"O", 2},  {"F", 1},  {"Ne", 0}, {"Na", 1}, {"Mg", 2},
    {"Al", 3}, {"Si", 4}, {"P", 5},  {"S", 6},  {"Cl", 1}, {"Ar", 0},
    {"K", 1},  {"Ca", 2}, {"Ga", 3}, {"Ge", 4}, {"As", 5}, {"Se", 6},
    {"Br", 1}, {"Kr", 0}, {"Rb", 1}, {"Sr", 2}, {"Te", 6}, {"I", 1},
    {"Xe", 0}, {"Cs", 1}, {"Ba", 2}};

struct ParseError {
  std::string msg;
};

Atom parse_bracket(const std::string& body) {
  Atom atom;
  atom.in_bracket = true;
  atom.explicit_h = 0;
  size_t i = 0;
  while (i < body.size() && std::isdigit((unsigned char)body[i])) i++;  // isotope
  if (i >= body.size()) throw ParseError{"empty bracket"};
  // element symbol (may be aromatic lowercase or '*')
  if (body[i] == '*') {
    atom.symbol = "*";
    i++;
  } else if (std::islower((unsigned char)body[i])) {
    atom.aromatic = true;
    std::string s(1, (char)std::toupper((unsigned char)body[i]));
    i++;
    // mirror the oracle's [a-z]{1,2}: one extra lowercase, greedy
    if (i < body.size() && std::islower((unsigned char)body[i])) {
      s += body[i];
      i++;
    }
    atom.symbol = s;
  } else if (std::isupper((unsigned char)body[i])) {
    // generic [A-Z][a-z]? — mirror the Python oracle's regex, which
    // consumes ONE following lowercase letter unconditionally
    std::string s(1, body[i]);
    i++;
    if (i < body.size() && std::islower((unsigned char)body[i])) {
      s += body[i];
      i++;
    }
    atom.symbol = s;
  } else {
    throw ParseError{"bad bracket atom"};
  }
  // chirality: the TH/AL/SP/TB/OH class suffix is only valid after at
  // least one '@' (otherwise 'OH3' in [COH3] would be eaten here)
  size_t n_at = 0;
  while (i < body.size() && body[i] == '@') {
    i++;
    n_at++;
  }
  if (n_at > 0 && i + 1 < body.size() &&
      (body.compare(i, 2, "TH") == 0 || body.compare(i, 2, "AL") == 0 ||
       body.compare(i, 2, "SP") == 0 || body.compare(i, 2, "TB") == 0 ||
       body.compare(i, 2, "OH") == 0)) {
    i += 2;
    while (i < body.size() && std::isdigit((unsigned char)body[i])) i++;
  }
  // H count
  if (i < body.size() && body[i] == 'H') {
    i++;
    if (i < body.size() && std::isdigit((unsigned char)body[i])) {
      atom.explicit_h = 0;
      while (i < body.size() && std::isdigit((unsigned char)body[i])) {
        atom.explicit_h = atom.explicit_h * 10 + (body[i] - '0');
        i++;
      }
    } else {
      atom.explicit_h = 1;
    }
  }
  // charge
  if (i < body.size() && (body[i] == '+' || body[i] == '-')) {
    char sign = body[i];
    int count = 0;
    while (i < body.size() && body[i] == sign) {
      count++;
      i++;
    }
    if (i < body.size() && std::isdigit((unsigned char)body[i])) {
      count = 0;
      while (i < body.size() && std::isdigit((unsigned char)body[i])) {
        count = count * 10 + (body[i] - '0');
        i++;
      }
    }
    atom.charge = sign == '+' ? count : -count;
  }
  // atom map
  if (i < body.size() && body[i] == ':') {
    i++;
    while (i < body.size() && std::isdigit((unsigned char)body[i])) i++;
  }
  if (i != body.size()) throw ParseError{"trailing bracket chars"};
  return atom;
}

void add_bond(Mol& mol, int a, int b, int order) {
  if (order == 0) {
    order = (mol.atoms[a].aromatic && mol.atoms[b].aromatic) ? AROMATIC
                                                            : SINGLE;
  }
  int bi = (int)mol.bonds.size();
  mol.bonds.push_back({a, b, order});
  mol.atoms[a].bonds.push_back(bi);
  mol.atoms[b].bonds.push_back(bi);
}

// ---- ring perception + aromaticity (mirrors smiles.py) ----------------

std::vector<std::vector<int>> find_rings(const Mol& mol,
                                         int max_size = 8) {
  int n = (int)mol.atoms.size();
  std::vector<std::vector<std::pair<int, int>>> adj(n);
  for (int bi = 0; bi < (int)mol.bonds.size(); bi++) {
    adj[mol.bonds[bi].a].push_back({mol.bonds[bi].b, bi});
    adj[mol.bonds[bi].b].push_back({mol.bonds[bi].a, bi});
  }
  std::vector<int> parent(n, -1), depth(n, -1);
  std::set<int> tree_bond;
  std::vector<int> extra;
  for (int root = 0; root < n; root++) {
    if (depth[root] >= 0) continue;
    depth[root] = 0;
    std::deque<int> q = {root};
    while (!q.empty()) {
      int v = q.front();
      q.pop_front();
      for (auto [w, bi] : adj[v]) {
        if (depth[w] < 0) {
          depth[w] = depth[v] + 1;
          parent[w] = v;
          tree_bond.insert(bi);
          q.push_back(w);
        } else if (!tree_bond.count(bi)) {
          extra.push_back(bi);
          tree_bond.insert(bi);
        }
      }
    }
  }
  std::vector<std::vector<int>> rings;
  std::set<std::set<int>> seen;
  for (int bi : extra) {
    int v = mol.bonds[bi].a, w = mol.bonds[bi].b;
    std::vector<int> pv = {v}, pw = {w};
    int a = v, b = w;
    while (a != b) {
      if (depth[a] >= depth[b]) {
        a = parent[a];
        pv.push_back(a);
      } else {
        b = parent[b];
        pw.push_back(b);
      }
    }
    std::vector<int> cycle(pv);
    for (int k = (int)pw.size() - 2; k >= 0; k--) cycle.push_back(pw[k]);
    if ((int)cycle.size() >= 3 && (int)cycle.size() <= max_size) {
      std::set<int> key(cycle.begin(), cycle.end());
      if (!seen.count(key)) {
        seen.insert(key);
        rings.push_back(cycle);
      }
    }
  }
  return rings;
}

void perceive_aromaticity(Mol& mol) {
  // max_size=12 so the azulene-class fused pass sees either member of a
  // 5-7 pair even when BFS yields the 10-periphery (mirrors smiles.py)
  auto all_cycles = find_rings(mol, 12);
  std::vector<std::vector<int>> rings;
  for (auto& r : all_cycles)
    if (r.size() <= 8) rings.push_back(r);
  std::map<std::pair<int, int>, int> bond_idx;
  for (int bi = 0; bi < (int)mol.bonds.size(); bi++) {
    bond_idx[{mol.bonds[bi].a, mol.bonds[bi].b}] = bi;
    bond_idx[{mol.bonds[bi].b, mol.bonds[bi].a}] = bi;
  }
  const std::set<std::string> pi_donors = {"N", "O", "S", "P"};
  bool changed = true;
  int guard = 0;
  while (changed && guard < 4) {
    changed = false;
    guard++;
    for (auto& r : rings) {
      std::vector<int> rb;
      for (size_t k = 0; k < r.size(); k++)
        rb.push_back(bond_idx[{r[k], r[(k + 1) % r.size()]}]);
      bool all_arom = true;
      for (int bi : rb)
        if (mol.bonds[bi].order != AROMATIC) all_arom = false;
      if (all_arom) continue;
      int pi = 0;
      bool ok = true;
      for (int a : r) {
        auto& atom = mol.atoms[a];
        int n_double = 0, n_triple = 0, n_arom = 0;
        bool has_ring_double = false;
        for (int bi : atom.bonds) {
          int o = mol.bonds[bi].order;
          if (o == DOUBLE) {
            n_double++;
            if (std::find(rb.begin(), rb.end(), bi) != rb.end())
              has_ring_double = true;
          } else if (o == TRIPLE) {
            n_triple++;
          } else if (o == AROMATIC) {
            n_arom++;
          }
        }
        static const std::set<std::string> allowed = {"C", "N", "O",
                                                      "S", "P", "B"};
        if (n_triple || !allowed.count(atom.symbol)) {
          ok = false;
          break;
        }
        bool exo_double = n_double > 0 && !has_ring_double;
        if (has_ring_double || n_arom) {
          pi += 1;
        } else if (exo_double) {
          // carbonyl-style sp2: contributes no ring pi electrons
        } else if (pi_donors.count(atom.symbol)) {
          pi += 2;
        } else if (atom.symbol == "C" && atom.charge == -1) {
          pi += 2;
        } else if ((atom.symbol == "C" || atom.symbol == "B") &&
                   atom.charge >= 0 && n_double == 0) {
          ok = false;
          break;
        }
      }
      if (ok && pi % 4 == 2) {
        for (int bi : rb) {
          if (mol.bonds[bi].order != AROMATIC) {
            mol.bonds[bi].order = AROMATIC;
            changed = true;
          }
        }
        for (int a : r) mol.atoms[a].aromatic = true;
      }
    }
    // fused-system pass (azulene-class, mirrors smiles.py): per-ring
    // Hueckel misses systems whose 4n+2 count only holds over the FUSED
    // pair (azulene = 5+7 rings, 10 pi); pentalene (8) and heptalene
    // (12) correctly fail the mod-4 test.
    for (size_t i1 = 0; i1 < all_cycles.size(); i1++) {
      for (size_t i2 = i1 + 1; i2 < all_cycles.size(); i2++) {
        auto& r1 = all_cycles[i1];
        auto& r2 = all_cycles[i2];
        std::set<int> s1(r1.begin(), r1.end());
        int shared = 0;
        for (int a : r2) shared += s1.count(a);
        if (shared < 2) continue;  // no shared bond: not fused
        std::vector<int> uni(r1);
        std::set<int> in_union(r1.begin(), r1.end());
        for (int a : r2)
          if (in_union.insert(a).second) uni.push_back(a);
        if (uni.size() > 10) continue;  // conservative: azulene class
        std::set<int> rb;
        for (size_t k = 0; k < r1.size(); k++)
          rb.insert(bond_idx[{r1[k], r1[(k + 1) % r1.size()]}]);
        for (size_t k = 0; k < r2.size(); k++)
          rb.insert(bond_idx[{r2[k], r2[(k + 1) % r2.size()]}]);
        bool all_arom = true;
        for (int bi : rb)
          if (mol.bonds[bi].order != AROMATIC) all_arom = false;
        if (all_arom) continue;
        int pi = 0;
        bool ok = true;
        for (int a : uni) {
          auto& atom = mol.atoms[a];
          int n_double = 0, n_triple = 0, n_arom = 0;
          bool has_sys_double = false;
          for (int bi : atom.bonds) {
            int o = mol.bonds[bi].order;
            if (o == DOUBLE) {
              n_double++;
              int other = mol.bonds[bi].a == a ? mol.bonds[bi].b
                                               : mol.bonds[bi].a;
              if (in_union.count(other)) has_sys_double = true;
            } else if (o == TRIPLE) {
              n_triple++;
            } else if (o == AROMATIC) {
              n_arom++;
            }
          }
          static const std::set<std::string> allowed = {"C", "N", "O",
                                                        "S", "P", "B"};
          if (n_triple || !allowed.count(atom.symbol)) {
            ok = false;
            break;
          }
          bool exo_double = n_double > 0 && !has_sys_double;
          if (has_sys_double || n_arom) {
            pi += 1;
          } else if (exo_double) {
            // carbonyl-style sp2: contributes no system pi electrons
          } else if (pi_donors.count(atom.symbol)) {
            pi += 2;
          } else if (atom.symbol == "C" && atom.charge == -1) {
            pi += 2;
          } else if ((atom.symbol == "C" || atom.symbol == "B") &&
                     atom.charge >= 0 && n_double == 0) {
            ok = false;
            break;
          }
        }
        if (ok && pi % 4 == 2) {
          for (int bi : rb) {
            if (mol.bonds[bi].order != AROMATIC) {
              mol.bonds[bi].order = AROMATIC;
              changed = true;
            }
          }
          for (int a : uni) mol.atoms[a].aromatic = true;
        }
      }
    }
  }
}

void finalize(Mol& mol) {
  perceive_aromaticity(mol);
  for (auto& atom : mol.atoms) {
    double s = 0;
    for (int bi : atom.bonds) s += bond_order(mol.bonds[bi].order);
    if (atom.in_bracket) {
      atom.num_h = atom.explicit_h < 0 ? 0 : atom.explicit_h;
    } else {
      auto it = kValences.find(atom.symbol);
      atom.num_h = 0;
      if (it != kValences.end()) {
        int need = (int)std::ceil(s);
        for (int v : it->second)
          if (v >= need) {
            atom.num_h = v - need;
            break;
          }
      }
    }
  }
  for (auto& atom : mol.atoms) {
    if (atom.aromatic) {
      atom.hybridization = 2;
      continue;
    }
    int n_double = 0, n_triple = 0;
    double bond_e = atom.num_h;
    for (int bi : atom.bonds) {
      int o = mol.bonds[bi].order;
      if (o == DOUBLE) n_double++;
      if (o == TRIPLE) n_triple++;
      bond_e += bond_order(o);
    }
    if (n_triple || n_double >= 2) {
      atom.hybridization = 1;
      continue;
    }
    auto it = kValenceElectrons.find(atom.symbol);
    if (it == kValenceElectrons.end()) {
      atom.hybridization = 0;
      continue;
    }
    int sigma = (int)atom.bonds.size() + atom.num_h;
    int lone = std::max(
        0, (int)((it->second - atom.charge - bond_e) / 2));
    int steric = sigma + lone;
    if (n_double == 1)
      atom.hybridization = 2;
    else if (steric >= 4)
      atom.hybridization = 3;
    else if (steric == 3)
      atom.hybridization = 2;
    else if (steric == 2)
      atom.hybridization = 1;
    else
      atom.hybridization = 0;
  }
}

// RDKit-parity valence sanitization; mirrors smiles.py
// _validate_valence exactly (self-contained: recomputes from the
// AS-WRITTEN bond orders so Python and C++ cannot drift in
// accept/reject behavior).  Aromatic bonds contribute 1 (minimal
// Kekule); the isoelectronic charge rule checks valence - charge for
// elements with >= 4 outer electrons, valence + charge otherwise.
void validate_valence(const Mol& mol, const std::vector<int>& written) {
  for (const auto& atom : mol.atoms) {
    auto lim = kMaxValence.find(atom.symbol);
    if (lim == kMaxValence.end() || atom.symbol == "*") continue;
    double wsum = 0.0;
    for (int bi : atom.bonds)
      wsum += written[bi] == AROMATIC ? 1.0 : (double)written[bi];
    int need = (int)std::ceil(wsum);
    int h = 0;
    if (atom.in_bracket) {
      h = atom.explicit_h < 0 ? 0 : atom.explicit_h;
    } else {
      auto it = kValences.find(atom.symbol);
      if (it != kValences.end())
        for (int v : it->second)
          if (v >= need) { h = v - need; break; }
    }
    int valence = need + h;
    auto ve = kValenceElectrons.find(atom.symbol);
    int outer = ve == kValenceElectrons.end() ? 0 : ve->second;
    int effective = outer >= 4 ? valence - atom.charge
                               : valence + atom.charge;
    if (effective > lim->second)
      throw ParseError{"valence exceeds permitted maximum"};
  }
}

// RDKit-parity kekulization check; mirrors smiles.py
// _validate_kekulizable exactly.  Every aromatic-written atom that
// needs a ring double bond must be coverable by a perfect matching
// over the written aromatic bonds (rejects e.g. n1cccc1 — pyrrole
// missing its [nH] — like RDKit's "Can't kekulize").  Exact
// backtracking with a step cap; cap overflow ACCEPTS.
bool kk_match(size_t k, const std::vector<int>& order,
              const std::map<int, std::vector<int>>& adj,
              std::set<int>& used, long& steps) {
  if (++steps > 100000) return true;
  while (k < order.size() && used.count(order[k])) k++;
  if (k == order.size()) return true;
  int u = order[k];
  for (int v : adj.at(u)) {
    if (!used.count(v)) {
      used.insert(u);
      used.insert(v);
      if (kk_match(k + 1, order, adj, used, steps)) return true;
      used.erase(u);
      used.erase(v);
    }
  }
  return false;
}

void validate_kekulizable(const Mol& mol,
                          const std::vector<int>& written,
                          const std::vector<char>& written_arom) {
  std::vector<int> needs;
  for (size_t i = 0; i < mol.atoms.size(); i++) {
    if (!written_arom[i]) continue;
    const Atom& atom = mol.atoms[i];
    int deg = (int)atom.bonds.size();
    int h = atom.explicit_h < 0 ? 0 : atom.explicit_h;
    int slots = deg + h;
    bool exo_multiple = false;
    for (int bi : atom.bonds)
      if (written[bi] == DOUBLE || written[bi] == TRIPLE)
        exo_multiple = true;
    const std::string& sym = atom.symbol;
    bool need = false;
    if (sym == "C" || sym == "Si") {
      need = atom.charge == 0 && !exo_multiple;
    } else if (sym == "N" || sym == "P" || sym == "As") {
      if (atom.charge == 0)
        need = slots == 2 && !exo_multiple;
      else if (atom.charge > 0)
        need = slots == 3 && !exo_multiple;
    } else if (sym == "O" || sym == "S" || sym == "Se" ||
               sym == "Te") {
      need = atom.charge > 0;
    }
    if (need) needs.push_back((int)i);
  }
  if (needs.empty()) return;
  std::set<int> need_set(needs.begin(), needs.end());
  std::map<int, std::vector<int>> adj;
  for (int i : needs) adj[i];
  for (size_t bi = 0; bi < mol.bonds.size(); bi++) {
    if (written[bi] != AROMATIC) continue;
    int a = mol.bonds[bi].a, b = mol.bonds[bi].b;
    if (need_set.count(a) && need_set.count(b)) {
      adj[a].push_back(b);
      adj[b].push_back(a);
    }
  }
  std::vector<int> order(needs);
  std::sort(order.begin(), order.end(), [&](int x, int y) {
    size_t dx = adj[x].size(), dy = adj[y].size();
    return dx != dy ? dx < dy : x < y;
  });
  std::set<int> used;
  long steps = 0;
  if (!kk_match(0, order, adj, used, steps))
    throw ParseError{"aromatic system cannot be kekulized"};
}

Mol parse_smiles(const std::string& s) {
  Mol mol;
  int prev = -1;
  int pending = 0;  // 0 = none
  std::vector<std::pair<int, int>> stack;
  std::map<int, std::pair<int, int>> rings;  // num -> (atom, order)
  size_t i = 0, n = s.size();
  while (i < n) {
    char c = s[i];
    if (c == '[') {
      size_t j = s.find(']', i);
      if (j == std::string::npos) throw ParseError{"unclosed bracket"};
      Atom atom = parse_bracket(s.substr(i + 1, j - i - 1));
      mol.atoms.push_back(atom);
      int idx = (int)mol.atoms.size() - 1;
      if (prev >= 0) add_bond(mol, prev, idx, pending);
      prev = idx;
      pending = 0;
      i = j + 1;
    } else if (std::isalpha((unsigned char)c) || c == '*') {
      Atom atom;
      // bare atoms: ORGANIC SUBSET only (Cl/Br the only two-letter)
      if (std::isupper((unsigned char)c) && i + 1 < n &&
          (s.substr(i, 2) == "Cl" || s.substr(i, 2) == "Br")) {
        atom.symbol = s.substr(i, 2);
        i += 2;
      } else if (std::islower((unsigned char)c)) {
        if (std::string("bcnops").find(c) == std::string::npos)
          throw ParseError{"unexpected aromatic atom"};
        atom.symbol = std::string(1, (char)std::toupper((unsigned char)c));
        atom.aromatic = true;
        i++;
      } else {
        if (c != '*' && std::string("BCNOPSFI").find(c) == std::string::npos)
          throw ParseError{"unexpected atom"};
        atom.symbol = std::string(1, c);
        i++;
      }
      mol.atoms.push_back(atom);
      int idx = (int)mol.atoms.size() - 1;
      if (prev >= 0) add_bond(mol, prev, idx, pending);
      prev = idx;
      pending = 0;
    } else if (c == '-' || c == '=' || c == '#' || c == ':' || c == '/' ||
               c == '\\' || c == '$') {
      pending = (c == '=') ? DOUBLE
                : (c == '#' || c == '$') ? TRIPLE
                : (c == ':') ? AROMATIC
                             : SINGLE;
      i++;
    } else if (std::isdigit((unsigned char)c) || c == '%') {
      int num;
      if (c == '%') {
        if (i + 2 >= n) throw ParseError{"bad %ring"};
        num = (s[i + 1] - '0') * 10 + (s[i + 2] - '0');
        i += 3;
      } else {
        num = c - '0';
        i++;
      }
      if (prev < 0) throw ParseError{"ring bond with no atom"};
      auto it = rings.find(num);
      if (it != rings.end()) {
        int a = it->second.first;
        int order = pending ? pending : it->second.second;
        rings.erase(it);
        if (a == prev) throw ParseError{"self ring bond"};
        add_bond(mol, a, prev, order);
      } else {
        rings[num] = {prev, pending};
      }
      pending = 0;
    } else if (c == '(') {
      stack.push_back({prev, pending});
      pending = 0;
      i++;
    } else if (c == ')') {
      if (stack.empty()) throw ParseError{"unbalanced ')'"};
      prev = stack.back().first;
      stack.pop_back();
      pending = 0;
      i++;
    } else if (c == '.') {
      prev = -1;
      pending = 0;
      i++;
    } else if (c == ' ' || c == '\t') {
      break;
    } else {
      throw ParseError{"unexpected char"};
    }
  }
  if (!rings.empty()) throw ParseError{"unclosed ring bonds"};
  if (!stack.empty()) throw ParseError{"unbalanced '('"};
  std::vector<int> written;
  written.reserve(mol.bonds.size());
  for (const auto& b : mol.bonds) written.push_back(b.order);
  std::vector<char> written_arom;
  written_arom.reserve(mol.atoms.size());
  for (const auto& a : mol.atoms) written_arom.push_back(a.aromatic);
  finalize(mol);
  validate_valence(mol, written);
  validate_kekulizable(mol, written, written_arom);
  return mol;
}

const char* kAtomSymbols[9] = {"H", "C", "N", "O", "F",
                               "S", "Cl", "Br", "I"};

}  // namespace

extern "C" {

// Featurize one SMILES.  Caller passes output buffers sized from
// glam_smiles_sizes().  Returns 0 on success, -1 on parse error.
// Node features: [n, 15] reference layout; edges both directions sorted
// by src*N+dst.
int glam_smiles_sizes(const char* smiles, int* n_atoms, int* n_edges) {
  try {
    Mol mol = parse_smiles(smiles);
    *n_atoms = (int)mol.atoms.size();
    *n_edges = 2 * (int)mol.bonds.size();
    return 0;
  } catch (...) {
    return -1;
  }
}

int glam_featurize(const char* smiles, float* x /* [n,15] */,
                   int32_t* senders, int32_t* receivers,
                   float* edge_attr /* [e,4] */) {
  try {
    Mol mol = parse_smiles(smiles);
    int n = (int)mol.atoms.size();
    if (n == 0) return -1;
    std::memset(x, 0, sizeof(float) * n * 15);
    for (int i = 0; i < n; i++) {
      const Atom& a = mol.atoms[i];
      for (int k = 0; k < 9; k++)
        if (a.symbol == kAtomSymbols[k]) x[i * 15 + k] = 1.0f;
      if (a.hybridization >= 1 && a.hybridization <= 3)
        x[i * 15 + 9 + (a.hybridization - 1)] = 1.0f;
      auto it = kAtomicNum.find(a.symbol);
      x[i * 15 + 12] = it == kAtomicNum.end() ? 0.0f : (float)it->second;
      x[i * 15 + 13] = a.aromatic ? 1.0f : 0.0f;
    }
    // explicit-H neighbor count
    for (const auto& b : mol.bonds) {
      if (mol.atoms[b.a].symbol == "H") x[b.b * 15 + 14] += 1.0f;
      if (mol.atoms[b.b].symbol == "H") x[b.a * 15 + 14] += 1.0f;
    }
    int e = (int)mol.bonds.size();
    std::vector<std::tuple<int64_t, int, int, int>> rows;  // key,s,d,order
    rows.reserve(2 * e);
    for (const auto& b : mol.bonds) {
      rows.push_back({(int64_t)b.a * n + b.b, b.a, b.b, b.order});
      rows.push_back({(int64_t)b.b * n + b.a, b.b, b.a, b.order});
    }
    std::stable_sort(rows.begin(), rows.end(),
                     [](const auto& p, const auto& q) {
                       return std::get<0>(p) < std::get<0>(q);
                     });
    std::memset(edge_attr, 0, sizeof(float) * 2 * e * 4);
    for (int k = 0; k < 2 * e; k++) {
      senders[k] = std::get<1>(rows[k]);
      receivers[k] = std::get<2>(rows[k]);
      int o = std::get<3>(rows[k]);
      int slot = o == SINGLE ? 0 : o == DOUBLE ? 1 : o == TRIPLE ? 2 : 3;
      edge_attr[k * 4 + slot] = 1.0f;
    }
    return 0;
  } catch (...) {
    return -1;
  }
}

// Single-parse variant: caller passes capacity-sized buffers; actual
// counts are returned through out_n/out_e.  Returns 0 ok, -1 parse
// error, -2 capacity exceeded.
int glam_featurize2(const char* smiles, int cap_atoms, int cap_edges,
                    float* x, int32_t* senders, int32_t* receivers,
                    float* edge_attr, int* out_n, int* out_e) {
  try {
    Mol mol = parse_smiles(smiles);
    int n = (int)mol.atoms.size();
    int e2 = 2 * (int)mol.bonds.size();
    if (n == 0) return -1;
    if (n > cap_atoms || e2 > cap_edges) return -2;
    *out_n = n;
    *out_e = e2;
    std::memset(x, 0, sizeof(float) * n * 15);
    for (int i = 0; i < n; i++) {
      const Atom& a = mol.atoms[i];
      for (int k = 0; k < 9; k++)
        if (a.symbol == kAtomSymbols[k]) x[i * 15 + k] = 1.0f;
      if (a.hybridization >= 1 && a.hybridization <= 3)
        x[i * 15 + 9 + (a.hybridization - 1)] = 1.0f;
      auto it = kAtomicNum.find(a.symbol);
      x[i * 15 + 12] = it == kAtomicNum.end() ? 0.0f : (float)it->second;
      x[i * 15 + 13] = a.aromatic ? 1.0f : 0.0f;
    }
    for (const auto& b : mol.bonds) {
      if (mol.atoms[b.a].symbol == "H") x[b.b * 15 + 14] += 1.0f;
      if (mol.atoms[b.b].symbol == "H") x[b.a * 15 + 14] += 1.0f;
    }
    std::vector<std::tuple<int64_t, int, int, int>> rows;
    rows.reserve(e2);
    for (const auto& b : mol.bonds) {
      rows.push_back({(int64_t)b.a * n + b.b, b.a, b.b, b.order});
      rows.push_back({(int64_t)b.b * n + b.a, b.b, b.a, b.order});
    }
    std::stable_sort(rows.begin(), rows.end(),
                     [](const auto& p, const auto& q) {
                       return std::get<0>(p) < std::get<0>(q);
                     });
    std::memset(edge_attr, 0, sizeof(float) * e2 * 4);
    for (int k = 0; k < e2; k++) {
      senders[k] = std::get<1>(rows[k]);
      receivers[k] = std::get<2>(rows[k]);
      int o = std::get<3>(rows[k]);
      int slot = o == SINGLE ? 0 : o == DOUBLE ? 1 : o == TRIPLE ? 2 : 3;
      edge_attr[k * 4 + slot] = 1.0f;
    }
    return 0;
  } catch (...) {
    return -1;
  }
}

// ELLPACK builder: fills nbr/eid [n,k] int32 and mask [n,k] uint8 from
// an edge list.  Returns 0 on success, -1 if any in-degree exceeds k.
int glam_build_ell(const int32_t* senders, const int32_t* receivers,
                   int n_edges, int n_nodes, int k, int32_t* nbr,
                   int32_t* eid, uint8_t* mask) {
  for (int i = 0; i < n_nodes * k; i++) {
    nbr[i] = n_nodes - 1;
    eid[i] = 0;
    mask[i] = 0;
  }
  std::vector<int> fill(n_nodes, 0);
  for (int e = 0; e < n_edges; e++) {
    int r = receivers[e];
    if (r < 0 || r >= n_nodes) return -1;
    int slot = fill[r];
    if (slot >= k) return -1;
    nbr[r * k + slot] = senders[e];
    eid[r * k + slot] = e;
    mask[r * k + slot] = 1;
    fill[r] = slot + 1;
  }
  return 0;
}

// Batch packer: the data-loader hot path (glam_tpu/data/graph.py
// pad_graphs core).  Packs n_graphs graphs (given as per-graph array
// pointers, zero-copy from numpy) into the padded static-shape batch
// buffers with the framework's padding convention: padded edges point
// at the last (padding) node, padding nodes belong to the last graph
// slot (id G-1), padding node positions restart at 0.  The Python
// implementation remains the byte-exact oracle (tests/test_native.py).
int glam_pack_batch(const float** nodes_list, const float** edges_list,
                    const int32_t** snd_list, const int32_t** rcv_list,
                    const int64_t* n_counts, const int64_t* e_counts,
                    int n_graphs, int fn, int fe, int num_nodes,
                    int num_edges, int G, float* nodes, float* edges,
                    int32_t* senders, int32_t* receivers,
                    int32_t* node_graph, int32_t* node_pos,
                    uint8_t* node_mask, uint8_t* edge_mask) {
  int64_t tot_n = 0, tot_e = 0;
  for (int g = 0; g < n_graphs; g++) {
    tot_n += n_counts[g];
    tot_e += e_counts[g];
  }
  if (tot_n > num_nodes || tot_e > num_edges || n_graphs > G - 1)
    return -2;  // over budget (caller raises like the Python path)
  std::memset(nodes, 0, sizeof(float) * num_nodes * fn);
  std::memset(edges, 0, sizeof(float) * num_edges * fe);
  for (int k = 0; k < num_edges; k++) {
    senders[k] = num_nodes - 1;
    receivers[k] = num_nodes - 1;
  }
  std::memset(node_mask, 0, num_nodes);
  std::memset(edge_mask, 0, num_edges);
  int64_t n_off = 0, e_off = 0;
  for (int g = 0; g < n_graphs; g++) {
    const int64_t n = n_counts[g], e = e_counts[g];
    std::memcpy(nodes + n_off * fn, nodes_list[g],
                sizeof(float) * n * fn);
    if (e > 0) {
      std::memcpy(edges + e_off * fe, edges_list[g],
                  sizeof(float) * e * fe);
      for (int64_t k = 0; k < e; k++) {
        senders[e_off + k] = snd_list[g][k] + (int32_t)n_off;
        receivers[e_off + k] = rcv_list[g][k] + (int32_t)n_off;
      }
    }
    for (int64_t k = 0; k < n; k++) {
      node_graph[n_off + k] = g;
      node_pos[n_off + k] = (int32_t)k;
      node_mask[n_off + k] = 1;
    }
    for (int64_t k = 0; k < e; k++) edge_mask[e_off + k] = 1;
    n_off += n;
    e_off += e;
  }
  for (int64_t k = n_off; k < num_nodes; k++) {
    node_graph[k] = G - 1;
    node_pos[k] = (int32_t)(k - n_off);
  }
  return 0;
}

}  // extern "C"
